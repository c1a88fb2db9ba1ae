"""Default full-text (BM25) document index (reference
``stdlib/indexing/full_text_document_index.py``)."""

from __future__ import annotations

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex


def default_full_text_document_index(
    data_column,
    data_table,
    *,
    metadata_column=None,
) -> DataIndex:
    inner = TantivyBM25(data_column, metadata_column)
    return DataIndex(data_table, inner)
