"""Lock-discipline annotations (clang ``GUARDED_BY``; counterpart of
``pathway_tpu/analysis/annotations.py``, framework-neutral).

:func:`guarded_by` declares, on a class, which attributes are protected
by which lock attribute::

    @guarded_by(_counters="_lock", _gauges="_lock")
    class MetricsRegistry: ...

The declaration is enforced twice:

* **statically** — the ``lock-unguarded-access`` pass
  (``pathway_tpu_torch/analysis/lock_discipline.py``) verifies every
  ``self.<field>`` access in the class body sits lexically inside a
  ``with self.<lock>:`` block (``__init__`` is exempt — construction
  precedes publication; a helper the caller must hold the lock for is
  marked :func:`assumes_held`);
* **at runtime** — ``analysis/runtime.py``'s sanitizer, when enabled,
  patches ``__setattr__`` on every registered class and reports writes
  to a guarded field while the declared lock is not held by the writing
  thread.

Module-level globals use the same convention without a decorator: a
module dict ``_GUARDED_BY = {"_ring": "_ring_lock"}`` declares its own
globals, and the static pass checks ``Name`` accesses the same way.

The decorators are metadata-only at runtime (no wrapping, no slots
interference): zero cost on instances unless the sanitizer is enabled.
"""

from __future__ import annotations

# classes carrying a __graft_guarded_by__ declaration, in registration
# order — the runtime sanitizer walks this to install its write checks
GUARDED_CLASSES: list[type] = []


def guarded_by(**fields: str):
    """Class decorator: ``field_name="lock_attr"`` pairs declaring which
    instance attributes must only be touched under which lock."""

    def deco(cls: type) -> type:
        merged = dict(getattr(cls, "__graft_guarded_by__", {}))
        merged.update(fields)
        cls.__graft_guarded_by__ = merged
        GUARDED_CLASSES.append(cls)
        return cls

    return deco


def assumes_held(lock: str):
    """Method decorator: the CALLER must already hold ``self.<lock>``.

    Exempts the method from the static with-block requirement (and
    documents the contract where it is easiest to miss)."""

    def deco(fn):
        held = set(getattr(fn, "__graft_assumes_held__", ()))
        held.add(lock)
        fn.__graft_assumes_held__ = frozenset(held)
        return fn

    return deco
