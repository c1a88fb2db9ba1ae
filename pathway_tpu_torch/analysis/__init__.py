"""graft-lint over the port (counterpart of ``pathway_tpu/analysis/``).

The port's conventions as AST passes with JAX's stable rule ids
(``python -m pathway_tpu_torch.analysis check``): no environment read
outside ``internals/config.py``'s choke points, every ``KNOBS`` entry an
argument some constructor takes, every kill-switch argument pinned by a
test, no host effect or hidden device sync on a kernel launch path, and
lock-guarded shared state in the threaded serving components. Plus the
runtime lock sanitizer (:mod:`pathway_tpu_torch.analysis.runtime`,
``runtime.configure(enabled=True)``) that records held-lock sets per
thread and reports lock-order inversions and unguarded guarded-field
writes.

Import surface is deliberately lazy: ``annotations`` (the
``guarded_by`` / ``assumes_held`` decorators) and ``runtime``
(``make_lock``) are imported by hot modules at package import time, so
this ``__init__`` must never pull the AST passes in.
"""

from __future__ import annotations

__all__ = ["check", "analyze_source", "RULES", "Finding"]


def __getattr__(name):
    if name in __all__:
        from pathway_tpu_torch.analysis import core

        return getattr(core, name)
    raise AttributeError(name)
