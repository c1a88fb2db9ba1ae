"""User-frame tracing — attribute engine errors to the user's code line.

Parity with reference ``internals/trace.py`` (``Frame:18``, ``Trace:42``,
``trace_user_frame:128``) + ``graph_runner/__init__.py:217-229``: at operator
creation time the first stack frame *outside* the framework is recorded; when
that operator later fails inside the engine, the error is re-raised pointing
at the user's line instead of engine internals.
"""

from __future__ import annotations

import dataclasses
import linecache
import os
import sys

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class Frame:
    filename: str
    line_number: int | None
    function: str

    @property
    def line(self) -> str:
        if self.line_number is None:
            return ""
        return linecache.getline(self.filename, self.line_number).strip()

    def is_external(self) -> bool:
        f = self.filename
        return not (
            f.startswith(_PACKAGE_ROOT)
            or f.startswith("<")
            or os.sep + "importlib" + os.sep in f
        )


@dataclasses.dataclass(frozen=True)
class Trace:
    user_frame: Frame | None

    @classmethod
    def empty(cls) -> "Trace":
        return cls(user_frame=None)

    def message(self) -> str | None:
        fr = self.user_frame
        if fr is None:
            return None
        out = f"called in {fr.filename}:{fr.line_number}"
        if fr.line:
            out += f"\n\t{fr.line}"
        return out


def capture_trace(skip: int = 1) -> Trace:
    """Walk the stack outward from the caller and keep the first frame that
    lives outside the pathway_tpu_torch package (the user's call site)."""
    try:
        frame = sys._getframe(skip)
    except ValueError:
        return Trace.empty()
    while frame is not None:
        code = frame.f_code
        fr = Frame(
            filename=code.co_filename,
            line_number=frame.f_lineno,
            function=code.co_qualname if hasattr(code, "co_qualname") else code.co_name,
        )
        if fr.is_external():
            return Trace(user_frame=fr)
        frame = frame.f_back
    return Trace.empty()


def trace_user_frame(fn):
    """Decorator (reference ``trace_user_frame:128``): on exception inside
    the wrapped API call, append the user's call-site to the error message."""

    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            trace = capture_trace(skip=2)
            msg = trace.message()
            if msg is not None and "called in " not in str(exc):
                exc.args = (f"{exc.args[0] if exc.args else exc}\n{msg}",) + tuple(
                    exc.args[1:]
                )
            raise

    wrapper.__name__ = getattr(fn, "__name__", "wrapped")
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


def add_error_trace(exc: Exception, trace: Trace | None) -> Exception:
    """Attach an operator-creation trace to an engine-run error (reference
    re-attribution at ``graph_runner/__init__.py:217-229``)."""
    if trace is None or trace.user_frame is None:
        return exc
    msg = trace.message()
    if msg and "called in " not in str(exc):
        exc.args = (f"{exc.args[0] if exc.args else exc}\noperator {msg}",) + tuple(
            exc.args[1:]
        )
    return exc
