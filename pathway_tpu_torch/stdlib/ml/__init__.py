"""Classic ML utilities (reference ``stdlib/ml/``). Ported so far: the
legacy ``KNNIndex`` API (``ml/index.py``). The classifiers, ``_lsh``,
``hmm``, ``datasets`` and the smart-table fuzzy join are not, and ``pw.ml``
waits for them (ROADMAP A13)."""

from pathway_tpu_torch.stdlib.ml import index
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["KNNIndex", "index"]
