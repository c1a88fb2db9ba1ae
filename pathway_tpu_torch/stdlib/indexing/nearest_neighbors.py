"""KNN inner indexes (reference ``stdlib/indexing/nearest_neighbors.py``).

``BruteForceKnn`` keeps its corpus on the card (``ops/knn.py``
``BruteForceKnnIndex``: one product and a top-k a search; ``device=None``
means CUDA, and ``device="cpu"`` is asked for by name). The IVF, HNSW
(uSearch), LSH, BM25 and hybrid factories and the mesh routing are not
ported yet (ROADMAP A13).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable

from pathway_tpu_torch.engine.operators.external_index import ExternalIndexFactory
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing.data_index import InnerIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory


async def _awaited(coro):
    return await coro


class DistanceMetric(enum.Enum):
    COS = "cos"
    L2SQ = "l2sq"


class BruteForceKnnMetricKind(enum.Enum):
    """Reference ``engine.pyi:882`` — metric kinds of the brute-force KNN."""

    L2SQ = "l2sq"
    COS = "cos"


class _KnnIndexFactory(ExternalIndexFactory):
    def __init__(self, dimensions, reserved_space, metric: str, device=None):
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.device = device

    def make_instance(self):
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

        return BruteForceKnnIndex(
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            device=self.device,
        )


class BruteForceKnn(InnerIndex):
    """Exact KNN with the corpus on the card (reference BruteForceKnn:170).
    ``device=None`` means CUDA (the index raises without it)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column=None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        metric: DistanceMetric | str = DistanceMetric.COS,
        embedder: Callable | None = None,
        device=None,
    ):
        super().__init__(data_column, metadata_column)
        self.device = device
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        # accepts DistanceMetric, the reference's metric-kind enums
        # (BruteForceKnnMetricKind / USearchMetricKind), or a plain string
        self.metric = (
            metric.value if isinstance(metric, enum.Enum) else str(metric)
        )
        if self.metric not in ("cos", "l2sq", "l2"):
            import warnings

            warnings.warn(
                f"metric {self.metric!r} has no kernel of its own; falling "
                f"back to cosine over unit-normalized vectors (rankings "
                f"differ from true {self.metric!r} on unnormalized data)",
                stacklevel=2,
            )
        self.embedder = embedder

    def index_vector_expr(self) -> ColumnExpression:
        if self.embedder is not None:
            return self.embedder(self.data_column)
        return self.data_column

    def query_vector_expr(self, query_column: ColumnExpression) -> ColumnExpression:
        if self.embedder is not None:
            return self.embedder(query_column)
        return query_column

    def make_factory(self):
        return _KnnIndexFactory(self.dimensions, self.reserved_space, self.metric,
                                self.device)


@dataclass
class KnnIndexFactory(InnerIndexFactory):
    """Shared base of the KNN factories (reference ``KnnIndexFactory:407``):
    resolves ``dimensions`` from the embedder when not given explicitly."""

    dimensions: int | None = None
    embedder: Callable | None = None

    def _get_embed_dimensions(self) -> int:
        fn = getattr(self.embedder, "__wrapped__", self.embedder)
        import asyncio
        import inspect

        probe = fn(".")
        if inspect.isawaitable(probe):
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                probe = asyncio.run(_awaited(probe))
            else:
                probe.close()
                raise RuntimeError(
                    "cannot probe an async embedder's dimensionality from "
                    "inside a running event loop; pass `dimensions=` "
                    "explicitly to the index factory"
                )
        return len(probe)

    def __post_init__(self):
        if self.dimensions is None and self.embedder is not None:
            self.dimensions = self._get_embed_dimensions()
        elif self.dimensions is None and self.embedder is None:
            raise ValueError(
                "Either `dimensions` or `embedder` must be provided to index factory."
            )


@dataclass
class BruteForceKnnFactory(KnnIndexFactory):
    reserved_space: int = 1024
    auxiliary_space: int = 1024 * 128
    metric: DistanceMetric | str = DistanceMetric.COS
    device: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions or 0,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
        )
