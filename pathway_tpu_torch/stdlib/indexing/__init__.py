"""``pw.indexing`` — vector/text indexes and the DataIndex retrieval API.

Parity with reference ``python/pathway/stdlib/indexing/``: ``DataIndex``
(``query`` / ``query_as_of_now``), inner indexes (``BruteForceKnn`` — the
corpus on the card, ``ops/knn.py``; ``IvfKnn`` — IVF-Flat on the card,
``ops/ivf.py``; ``USearchKnn`` — a host HNSW graph, ``ops/hnsw.py``;
``LshKnn`` — the exact path under the LSH API; ``TantivyBM25`` — host-side
BM25), ``HybridIndex`` (RRF fusion), the factories (``mesh=`` routes the
brute-force and IVF ones to the sharded IVF) and the default document
indexes. The sorted index is not ported yet (ROADMAP A13).
"""

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex
from pathway_tpu_torch.stdlib.indexing.hybrid_index import (
    HybridIndex,
    HybridIndexDataIndex,
    HybridIndexFactory,
)
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    DistanceMetric,
    IvfKnn,
    IvfKnnFactory,
    KnnIndexFactory,
    LshKnn,
    LshKnnFactory,
    USearchKnn,
    USearchMetricKind,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    AbstractRetrieverFactory,
    InnerIndexFactory,
)
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    VectorDocumentIndex,
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)
from pathway_tpu_torch.stdlib.indexing.sorting import (
    SortedIndex,
    build_sorted_index,
    retrieve_prev_next_values,
    sort_from_index,
)

__all__ = [
    "BruteForceKnnMetricKind",
    "USearchMetricKind",
    "SortedIndex",
    "build_sorted_index",
    "retrieve_prev_next_values",
    "sort_from_index",
    "DataIndex",
    "InnerIndex",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "IvfKnn",
    "IvfKnnFactory",
    "USearchKnn",
    "UsearchKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "KnnIndexFactory",
    "InnerIndexFactory",
    "VectorDocumentIndex",
    "DistanceMetric",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexDataIndex",
    "HybridIndexFactory",
    "AbstractRetrieverFactory",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_lsh_knn_document_index",
    "default_full_text_document_index",
]
