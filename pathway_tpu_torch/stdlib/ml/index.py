"""Legacy ``KNNIndex`` API (reference ``stdlib/ml/index.py``: KNNIndex:9,
get_nearest_items:54, get_nearest_items_asof_now:194).

The reference implements this with LSH bucketing in pure dataflow; here it
delegates to the brute-force index on the card (exact; ``device=None`` is
CUDA, as every port entry point) while keeping the public API: queries/data
as vector columns, results collapsed.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnn


class KNNIndex:
    def __init__(
        self,
        data_embedding: expr_mod.ColumnReference,
        data: Any,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: expr_mod.ColumnReference | None = None,
        device=None,
    ):
        metric = "l2sq" if distance_type == "euclidean" else "cos"
        self._inner = BruteForceKnn(
            data_embedding,
            metadata,
            dimensions=n_dimensions,
            metric=metric,
            device=device,
        )
        self._index = DataIndex(data, self._inner)

    def get_nearest_items(
        self,
        query_embedding: expr_mod.ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: expr_mod.ColumnExpression | None = None,
    ):
        return self._index.query(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            with_distances=with_distances,
            metadata_filter=metadata_filter,
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding: expr_mod.ColumnReference,
        k: int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: expr_mod.ColumnExpression | None = None,
    ):
        return self._index.query_as_of_now(
            query_embedding,
            number_of_matches=k,
            collapse_rows=collapse_rows,
            with_distances=with_distances,
            metadata_filter=metadata_filter,
        )
