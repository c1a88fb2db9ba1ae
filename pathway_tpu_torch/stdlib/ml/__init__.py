"""``pw.ml`` — classic ML utilities (counterpart of
``pathway_tpu/stdlib/ml/``, reference ``stdlib/ml/``): the legacy
``KNNIndex`` API (``ml/index.py``), the LSH classifiers and clustering
(whose k-means runs on the card), the HMM reducer, datasets and the
smart-table fuzzy join."""

from pathway_tpu_torch.stdlib.ml import (
    classifiers,
    datasets,
    hmm,
    index,
    smart_table_ops,
    utils,
)
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = [
    "KNNIndex",
    "classifiers",
    "datasets",
    "hmm",
    "index",
    "smart_table_ops",
    "utils",
]
