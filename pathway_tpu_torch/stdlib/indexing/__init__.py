"""``pw.indexing`` — the DataIndex retrieval API and its KNN inner index.

Parity with reference ``python/pathway/stdlib/indexing/``: ``DataIndex``
(``query`` / ``query_as_of_now``) over ``BruteForceKnn`` (corpus on the
card, ``ops/knn.py``) and its factories. The IVF, HNSW (uSearch), LSH, BM25
and hybrid indexes, the document-index defaults and the sorted index are
not ported yet (ROADMAP A13).
"""

from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    DistanceMetric,
    KnnIndexFactory,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    AbstractRetrieverFactory,
    InnerIndexFactory,
)

__all__ = [
    "BruteForceKnnMetricKind",
    "DataIndex",
    "InnerIndex",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "KnnIndexFactory",
    "InnerIndexFactory",
    "DistanceMetric",
    "AbstractRetrieverFactory",
]
