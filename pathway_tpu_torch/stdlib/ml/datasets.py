"""Dataset helpers (counterpart of ``pathway_tpu/stdlib/ml/datasets.py``,
reference ``stdlib/ml/datasets/classification``: ``load_mnist_sample`` /
``load_mnist_stream``).

The reference fetches MNIST from OpenML. The port has no network path:
its fetch raises, as JAX's does offline, and the loader takes the
deterministic synthetic stand-in JAX falls back to, with the same shape
contract (784-dim float vectors in [0, 1], string digit labels, 6:1
train/test split) and the same values for the same size.
"""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.debug import table_from_pandas


def _synthetic_mnist(n: int, seed: int = 0):
    """Ten well-separated Gaussian blobs in 784-d, mimicking MNIST's shape."""
    gen = np.random.default_rng(seed)
    centers = gen.random((10, 784))
    labels = gen.integers(0, 10, size=n)
    X = np.clip(centers[labels] + gen.normal(0, 0.08, size=(n, 784)), 0.0, 1.0)
    y = labels.astype(str)
    return X, y


def _download_mnist():
    """JAX's OpenML download, which the port does not make."""
    raise OSError("MNIST is not downloaded: the port makes no network request")


def _fetch_mnist(sample_size: int):
    try:
        return _download_mnist()
    except Exception:
        import warnings

        warnings.warn(
            "MNIST download unavailable (no network); using a deterministic "
            "synthetic stand-in with the same shape contract.",
            stacklevel=3,
        )
        return _synthetic_mnist(max(sample_size, 7000))


def load_mnist_sample(sample_size: int = 70000):
    """Return (X_train, y_train, X_test, y_test) tables with columns
    ``data`` (784-dim vector) / ``label`` (str), split 6:1."""
    import pandas as pd

    X, y = _fetch_mnist(sample_size)
    n = min(sample_size, len(X))
    train_size = int(n * 6 / 7)
    test_size = n - train_size
    X_train, y_train = X[:train_size], y[:train_size]
    X_test, y_test = X[train_size:train_size + test_size], y[train_size:train_size + test_size]

    def vec_table(mat):
        # list(mat) yields row views without boxing every float
        return table_from_pandas(pd.DataFrame({"data": list(mat)}))

    def label_table(labels):
        return table_from_pandas(pd.DataFrame({"label": labels.tolist()}))

    return (
        vec_table(X_train),
        label_table(y_train),
        vec_table(X_test),
        label_table(y_test),
    )


load_mnist_stream = load_mnist_sample


def load_mnist(*args, **kwargs):
    return load_mnist_sample(*args, **kwargs)
