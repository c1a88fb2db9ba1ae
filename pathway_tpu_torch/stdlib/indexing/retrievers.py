"""Retriever factory protocol (reference ``stdlib/indexing/retrievers.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class AbstractRetrieverFactory(ABC):
    @abstractmethod
    def build_index(self, data_column, data_table, metadata_column=None): ...


class InnerIndexFactory(AbstractRetrieverFactory):
    """Factory whose indices are ``InnerIndex`` instances wrapped into a
    ``DataIndex`` (reference ``retrievers.py:17``)."""

    def build_inner_index(self, data_column, metadata_column=None):
        raise NotImplementedError

    def build_index(self, data_column, data_table, metadata_column=None):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        inner = self.build_inner_index(data_column, metadata_column)
        return DataIndex(data_table, inner)
