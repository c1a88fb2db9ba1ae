"""Lazy resolution of the port's native wrappers (counterpart of
``pathway_tpu/native/binding.py``).

:func:`native_bind` returns the wrapper of that name defined in
:mod:`pathway_tpu_torch.native` (``batch_rows_split``, ``hash_tokenize``,
``csv_cols``, ...). JAX's returns ``None`` when its extension is missing and
lets the caller take a Python path; the port's native layer builds at first
use and raises when it cannot (no ``g++``, a failed build), so an unknown
name raises here too and nothing falls back.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def native_bind(name: str):
    from pathway_tpu_torch import native as native_mod

    fn = getattr(native_mod, name, None)
    if fn is None or name.startswith("_") or not callable(fn):
        raise AttributeError(f"pathway_tpu_torch.native has no wrapper {name!r}")
    return fn
