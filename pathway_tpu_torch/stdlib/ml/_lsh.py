"""LSH bucketers (counterpart of ``pathway_tpu/stdlib/ml/_lsh.py``, reference
``stdlib/ml/classifiers/_lsh.py``).

``generate_euclidean_lsh_bucketer`` / ``generate_cosine_lsh_bucketer`` build
callables mapping a vector to ``L`` integer bucket ids (one per OR-band, each
the AND of ``M`` hashes).  ``lsh`` applies a bucketer to a vector column and
flattens the table to one row per (origin row, band).

The projections are a single ``(d, M*L)`` matmul per vector; when applied to a
whole column it runs per row, a ``(d,) @ (d, M*L)`` product: host numpy, as
in JAX. ``np.random.default_rng(seed)`` draws the same planes and shifts as
the JAX package, and the band ids are the same fingerprints, so bucket ids
are equal across the two packages.
"""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.fingerprints import fingerprint
from pathway_tpu_torch.stdlib.utils.col import unpack_col


def generate_euclidean_lsh_bucketer(d: int, M: int, L: int, A: float = 1.0, seed=0):
    """LSH for Euclidean distance: project on ``M*L`` random unit lines,
    quantize into buckets of width ``A``, fingerprint each band of ``M``."""
    gen = np.random.default_rng(seed=seed)
    lines = gen.standard_normal((d, M * L))
    lines = lines / np.linalg.norm(lines, axis=0)
    shift = gen.random(size=M * L) * A

    def bucketify(x: np.ndarray) -> np.ndarray:
        quantized = np.floor_divide(np.asarray(x) @ lines + shift, A).astype(int)
        bands = np.split(quantized, L)
        return np.array([fingerprint(band.tobytes(), format="i32") for band in bands])

    return bucketify


def generate_cosine_lsh_bucketer(d: int, M: int, L: int, seed=0):
    """LSH for cosine similarity: sign patterns against ``M*L`` random
    hyperplanes, each band of ``M`` signs packed into one integer."""
    gen = np.random.default_rng(seed=seed)
    planes = gen.standard_normal((d, M * L))
    powers = 2 ** np.arange(M)

    def bucketify(x: np.ndarray) -> np.ndarray:
        signs = (np.asarray(x) @ planes >= 0).astype(int)
        bands = np.split(signs, L)
        return np.array([int(band @ powers) for band in bands])

    return bucketify


def lsh(data, bucketer, origin_id: str = "origin_id", include_data: bool = True):
    """Apply ``bucketer`` to ``data.data`` and flatten: one output row per
    (input row, band) with columns ``bucketing`` (band index), ``band``
    (bucket id) and, when ``include_data``, the original vector."""
    flat = data.select(
        buckets=expr_mod.apply(
            lambda x: [(i, int(b)) for i, b in enumerate(bucketer(x))], data.data
        )
    )
    flat = flat.flatten(flat.buckets, origin_id=origin_id)
    result = flat.select(flat[origin_id]) + unpack_col(
        flat.buckets, "bucketing", "band"
    )
    if include_data:
        result += result.select(data.ix(result[origin_id]).data)
    return result
