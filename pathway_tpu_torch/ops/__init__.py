"""pathway_tpu_torch.ops — brute-force KNN, the IVF-Flat and HNSW indexes,
the late-interaction doc-token bank, the fused RAG query path and the
query server, plus the shared padding helpers (copied from
``pathway_tpu.ops``).

PyTorch runs eagerly, so padding to power-of-two buckets no longer buys
executable reuse; the port keeps the same buckets so its shapes, and with
them its numerics, match the JAX package row for row.
"""

import math


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor). ``floor`` must be a power of
    two; it sets the minimum bucket."""
    return max(floor, 1 << math.ceil(math.log2(max(n, 1))))


def canonical_metric(metric) -> str:
    """Normalise a metric name: anything starting with "l2" means squared
    L2; everything else is cosine/dot on normalised vectors."""
    return "l2" if str(metric).lower().startswith("l2") else "cos"


def prep_host_vectors(vectors, metric: str):
    """Host-side (numpy) prep shared by the vector indexes: (m, d) float32,
    unit-normalised for cosine (zero vectors pass through unscaled)."""
    import numpy as np

    v = np.asarray(vectors, dtype=np.float32)
    if v.ndim == 1:
        v = v[None, :]
    if metric == "cos":
        norms = np.linalg.norm(v, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        v = v / norms
    return v
