"""Helper for import errors pointing at optional extras (counterpart of
``pathway_tpu/optional_import.py``; reference
``python/pathway/optional_import.py``)."""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def optional_imports(extra: str):
    try:
        yield
    except ImportError as e:
        raise ImportError(
            f"{e}. Consider installing 'pathway_tpu_torch[{extra}]'"
        ) from e
