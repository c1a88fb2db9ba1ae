"""The global error log (counterpart of ``ErrorLog`` and
``get_global_error_log`` in ``pathway_tpu/internals/errors.py``, without
the dataflow engine's error tables).

The serving loops log what supervision absorbed here: a supervised
restart, a request that failed past its retry budget, a loop that died,
a thread still alive after its shutdown join. Tests and operators read
``get_global_error_log().entries`` for failures that did not surface as
an exception.
"""

from __future__ import annotations

import threading
from typing import Any


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
