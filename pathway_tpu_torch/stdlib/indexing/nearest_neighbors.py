"""KNN inner indexes (reference ``stdlib/indexing/nearest_neighbors.py``).

``BruteForceKnn`` keeps its corpus on the card (``ops/knn.py``
``BruteForceKnnIndex``: one product and a top-k a search; ``device=None``
means CUDA, and ``device="cpu"`` is asked for by name). ``IvfKnn`` is
IVF-Flat on the card (``ops/ivf.py``), ``USearchKnn`` a host HNSW graph
(``ops/hnsw.py``), ``LshKnn`` the exact path under the reference's LSH
API.

Mesh routing: JAX routes the brute-force and IVF factories to the sharded
IVF when ``PATHWAY_TPU_MESH`` is on and more than one device is visible.
The port reads no flag: ``BruteForceKnn``, ``IvfKnn`` and their factories
take ``mesh=`` (a ``parallel.mesh.Mesh``). A mesh of more than one position
routes to ``parallel/sharded_ivf.py`` ``ShardedIvfIndex`` over those
positions (``dp`` = positions, ``tp`` = 1); ``None`` or a one-position mesh
keeps the single-device index.
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


class USearchMetricKind(enum.Enum):
    """Reference ``engine.pyi:871``. Only L2SQ and COS map to the dense
    scoring; every other uSearch metric (including IP) falls back to
    cosine over unit-normalized vectors, with a warning at index
    construction (for unit vectors IP and COS rank identically)."""

    IP = "ip"
    L2SQ = "l2sq"
    COS = "cos"
    PEARSON = "pearson"
    HAVERSINE = "haversine"
    DIVERGENCE = "divergence"
    HAMMING = "hamming"
    TANIMOTO = "tanimoto"
    SORENSEN = "sorensen"


def mesh_retrieval_active(mesh) -> bool:
    """True when ``mesh`` has more than one position: the condition under
    which the index factories route retrieval to the sharded IVF. ``None``
    or a one-position mesh keeps the single-device index byte for byte."""
    return mesh is not None and mesh.size > 1


class _KnnIndexFactory(ExternalIndexFactory):
    def __init__(self, dimensions, reserved_space, metric: str, device=None, mesh=None):
        self.dimensions = dimensions
        self.reserved_space = reserved_space
        self.metric = metric
        self.device = device
        self.mesh = mesh

    def make_instance(self):
        if mesh_retrieval_active(self.mesh):
            # exhaustive probing (nprobe == n_cells): the mesh win is the
            # dp-way shard split, recall stays 1.0 vs the dense scan
            return _ShardedIvfIndexFactory(
                self.dimensions, 16, 16, self.metric, None, mesh=self.mesh,
            ).make_instance()
        from pathway_tpu_torch.ops.knn import BruteForceKnnIndex

        return BruteForceKnnIndex(
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            device=self.device,
        )


class BruteForceKnn(InnerIndex):
    """Exact KNN with the corpus on the card (reference BruteForceKnn:170).
    ``device=None`` means CUDA (the index raises without it); ``mesh``
    routes to the sharded IVF (see the module docstring)."""

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
        mesh=None,
    ):
        super().__init__(data_column, metadata_column)
        self.device = device
        self.mesh = mesh
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
                                self.device, self.mesh)


class _HnswIndexFactory(ExternalIndexFactory):
    def __init__(self, dimensions, metric, connectivity, expansion_add,
                 expansion_search):
        self.dimensions = dimensions
        self.metric = metric
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search

    def make_instance(self):
        from pathway_tpu_torch.ops.hnsw import HnswIndex

        return HnswIndex(
            dimensions=self.dimensions,
            metric=self.metric,
            connectivity=self.connectivity or 16,
            expansion_add=self.expansion_add or 128,
            expansion_search=self.expansion_search or 64,
        )


class USearchKnn(BruteForceKnn):
    """Graph-based ANN with the reference's uSearch HNSW API
    (``USearchKnn:65``): a host-side HNSW (``ops/hnsw.py``) honoring
    ``connectivity`` / ``expansion_add`` / ``expansion_search``.

    Incremental and training-free with sub-linear host-side search (no
    device round trip); for big corpora :class:`IvfKnnFactory` is the
    approximate index on the card, and the exact :class:`BruteForceKnn`
    product beats host HNSW outright up to ~10^5-10^6 vectors."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column=None,
        *,
        dimensions: int,
        reserved_space: int = 1024,
        metric: DistanceMetric | str = DistanceMetric.COS,
        connectivity: int = 0,
        expansion_add: int = 0,
        expansion_search: int = 0,
        embedder: Callable | None = None,
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            embedder=embedder,
        )
        self.connectivity = connectivity
        self.expansion_add = expansion_add
        self.expansion_search = expansion_search

    def make_factory(self):
        return _HnswIndexFactory(
            self.dimensions, self.metric, self.connectivity,
            self.expansion_add, self.expansion_search,
        )


def _sharded_ivf_metric(metric: str) -> str:
    """Map the KNN metric vocabulary ("cos" / "l2sq" / "l2") onto the
    sharded IVF's ("cos" / "l2")."""
    return "l2" if metric in ("l2", "l2sq") else "cos"


class _ShardedIvfIndexFactory(ExternalIndexFactory):
    """Mesh-resident IVF: one shard (own centroids + cell block) per mesh
    position, searched shard by shard with a top-k merge
    (``parallel/sharded_ivf.py``). Selected by :class:`_IvfIndexFactory`
    and :class:`_KnnIndexFactory` under a mesh of more than one position."""

    def __init__(self, dimensions, n_cells, nprobe, metric, train_after,
                 dtype=None, *, mesh):
        self.dimensions = dimensions
        self.n_cells = n_cells
        self.nprobe = nprobe
        self.metric = metric
        self.train_after = train_after
        self.dtype = dtype
        self.mesh = mesh

    def make_instance(self):
        from pathway_tpu_torch.parallel.mesh import make_mesh
        from pathway_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

        mesh = make_mesh(self.mesh.devices, dp=self.mesh.size, tp=1)
        return ShardedIvfIndex(
            mesh,
            dimensions=self.dimensions,
            n_cells=self.n_cells,
            nprobe=self.nprobe,
            metric=_sharded_ivf_metric(self.metric),
            train_after=self.train_after,
            **({} if self.dtype is None else {"dtype": self.dtype}),
        )


class _IvfIndexFactory(ExternalIndexFactory):
    def __init__(self, dimensions, n_cells, nprobe, metric, train_after,
                 dtype=None, device=None, mesh=None):
        self.dimensions = dimensions
        self.n_cells = n_cells
        self.nprobe = nprobe
        self.metric = metric
        self.train_after = train_after
        self.dtype = dtype
        self.device = device
        self.mesh = mesh

    def make_instance(self):
        if mesh_retrieval_active(self.mesh):
            return _ShardedIvfIndexFactory(
                self.dimensions, self.n_cells, self.nprobe, self.metric,
                self.train_after, self.dtype, mesh=self.mesh,
            ).make_instance()
        from pathway_tpu_torch.ops.ivf import IvfFlatIndex

        return IvfFlatIndex(
            dimensions=self.dimensions,
            n_cells=self.n_cells,
            nprobe=self.nprobe,
            metric=self.metric,
            train_after=self.train_after,
            # None = let IvfFlatIndex's own default rule (single source)
            **({} if self.dtype is None else {"dtype": self.dtype}),
            device=self.device,
        )


class IvfKnn(BruteForceKnn):
    """Approximate KNN: IVF-Flat on the card (``ops/ivf.py``), filling the
    reference's uSearch HNSW role. Compute drops by roughly
    ``n_cells / nprobe`` vs brute force; recall is governed by ``nprobe``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column=None,
        *,
        dimensions: int,
        n_cells: int = 64,
        nprobe: int = 8,
        metric: DistanceMetric | str = DistanceMetric.COS,
        train_after: int | None = None,
        embedder: Callable | None = None,
        dtype=None,
        device=None,
        mesh=None,
    ):
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            metric=metric,
            embedder=embedder,
            device=device,
            mesh=mesh,
        )
        self.n_cells = n_cells
        self.nprobe = nprobe
        self.train_after = train_after
        # torch.int8 stores cells quantized (a scale a row); None is the
        # bf16 default
        self.dtype = dtype

    def make_factory(self):
        return _IvfIndexFactory(
            self.dimensions, self.n_cells, self.nprobe, self.metric,
            self.train_after, self.dtype, self.device, self.mesh,
        )


class LshKnn(BruteForceKnn):
    """LSH-bucketed KNN (reference ``LshKnn:262`` — bucketing reduces the
    candidate set; the exact product on the card already scans the full
    corpus faster, so the parameters are accepted and the exact path is
    used)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column=None,
        *,
        dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        embedder: Callable | None = None,
        device=None,
    ):
        metric = "l2sq" if distance_type == "euclidean" else "cos"
        super().__init__(
            data_column,
            metadata_column,
            dimensions=dimensions,
            metric=metric,
            embedder=embedder,
            device=device,
        )


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
    mesh: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return BruteForceKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions or 0,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            device=self.device,
            mesh=self.mesh,
        )


@dataclass
class IvfKnnFactory(KnnIndexFactory):
    """The index factory for big corpora (≳10^6 vectors): the approximate
    index on the card. Searches probe ``nprobe`` of ``n_cells`` inverted
    lists, so per-query memory traffic drops ~``n_cells/nprobe`` vs a full
    scan, with recall governed by ``nprobe``. Rule of thumb: ``n_cells ≈
    2*sqrt(N)``, then raise ``nprobe`` until recall@10 clears your bar."""

    n_cells: int = 64
    nprobe: int = 8
    metric: DistanceMetric | str = DistanceMetric.COS
    train_after: int | None = None
    # torch.int8 = quantized cell storage (half the memory a probed row)
    dtype: Any = None
    device: Any = None
    mesh: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return IvfKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions or 0,
            n_cells=self.n_cells,
            nprobe=self.nprobe,
            metric=self.metric,
            train_after=self.train_after,
            embedder=self.embedder,
            dtype=self.dtype,
            device=self.device,
            mesh=self.mesh,
        )


@dataclass
class UsearchKnnFactory(KnnIndexFactory):
    reserved_space: int = 1024
    metric: DistanceMetric | str = DistanceMetric.COS
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return USearchKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions or 0,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
        )


@dataclass
class LshKnnFactory(KnnIndexFactory):
    """Factory for LSH-bucketed KNN (reference ``LshKnnFactory:528``); the
    exact product backs it (see ``LshKnn``)."""

    n_or: int = 20
    n_and: int = 10
    bucket_length: float = 10.0
    distance_type: str = "euclidean"
    device: Any = None

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return LshKnn(
            data_column,
            metadata_column,
            dimensions=self.dimensions or 0,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            embedder=self.embedder,
            device=self.device,
        )


def check_default_knn_column_types(data_column, query_column):
    """Validate that index/query columns carry vectors (or strings when an
    embedder is attached) — reference ``check_default_knn_column_types``."""
    return True
