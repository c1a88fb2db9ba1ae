"""Default vector document index constructors (reference
``stdlib/indexing/vector_document_index.py``). The card indexes take
``device=None`` (CUDA), as every port entry point does; the host HNSW of
``default_usearch_knn_document_index`` needs none."""

from __future__ import annotations

from typing import Callable

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    DistanceMetric,
    LshKnn,
    USearchKnn,
)


def VectorDocumentIndex(
    data_column,
    data_table,
    *,
    dimensions: int,
    embedder: Callable | None = None,
    metadata_column=None,
    device=None,
):
    """Deprecated alias of ``default_vector_document_index`` (reference
    ``vector_document_index.py:12``)."""
    import warnings

    warnings.warn(
        "this part of API will be removed soon, "
        "please use default_vector_document_index instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return default_vector_document_index(
        data_column,
        data_table,
        embedder=embedder,
        dimensions=dimensions,
        metadata_column=metadata_column,
        device=device,
    )


def default_vector_document_index(
    data_column,
    data_table,
    *,
    embedder: Callable | None = None,
    dimensions: int,
    metadata_column=None,
    device=None,
) -> DataIndex:
    return default_brute_force_knn_document_index(
        data_column,
        data_table,
        embedder=embedder,
        dimensions=dimensions,
        metadata_column=metadata_column,
        device=device,
    )


def default_brute_force_knn_document_index(
    data_column,
    data_table,
    *,
    embedder: Callable | None = None,
    dimensions: int,
    metadata_column=None,
    device=None,
) -> DataIndex:
    inner = BruteForceKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        metric=DistanceMetric.COS,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)


def default_usearch_knn_document_index(
    data_column,
    data_table,
    *,
    embedder: Callable | None = None,
    dimensions: int,
    metadata_column=None,
) -> DataIndex:
    inner = USearchKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        metric=DistanceMetric.COS,
        embedder=embedder,
    )
    return DataIndex(data_table, inner)


def default_lsh_knn_document_index(
    data_column,
    data_table,
    *,
    embedder: Callable | None = None,
    dimensions: int,
    metadata_column=None,
    device=None,
) -> DataIndex:
    inner = LshKnn(
        data_column,
        metadata_column,
        dimensions=dimensions,
        embedder=embedder,
        device=device,
    )
    return DataIndex(data_table, inner)
