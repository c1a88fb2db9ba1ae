"""Error handling and the global error log (counterpart of
``pathway_tpu/internals/errors.py``).

Parity with reference ``src/engine/error.rs`` + ``internals/errors.py``:
errors inside expressions become ``ERROR`` sentinel values that propagate
instead of aborting (when ``terminate_on_error=False``); every error is also
appended to an error-log table readable via ``pw.global_error_log()``.

The serving loops log what supervision absorbed here too: a supervised
restart, a request that failed past its retry budget, a loop that died, a
thread still alive after its shutdown join. Tests and operators read
``get_global_error_log().entries`` for failures that did not surface as an
exception.
"""

from __future__ import annotations

import threading
from typing import Any


class EngineError(Exception):
    """Engine-originating error re-raised to user code."""


class EngineErrorWithTrace(EngineError):
    def __init__(self, message: str, trace=None):
        super().__init__(message)
        self.trace = trace


class KeyMissingInOutputTable(KeyError):
    pass


class ErrorLog:
    """Collects (message, operator) error records during a run."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries: list[dict[str, Any]] = []

    def log(self, message: str, operator: str | None = None) -> None:
        with self._lock:
            self.entries.append({"message": str(message), "operator": operator})

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()


_global_log = ErrorLog()


def get_global_error_log() -> ErrorLog:
    return _global_log


def global_error_log():
    """Return a Table of error messages recorded in the last run."""
    from pathway_tpu_torch.internals import table as table_mod

    return table_mod.Table._from_error_log(_global_log)


def local_error_log():
    return global_error_log()
