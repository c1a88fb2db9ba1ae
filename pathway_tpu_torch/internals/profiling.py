"""On-demand device profiling: a ``torch.profiler`` trace capture behind an
opt-in directory (counterpart of ``pathway_tpu/internals/profiling.py``,
which captures with ``jax.profiler``).

``GET /debug/profile?ms=N`` on a :class:`BaseRestServer` built with
``profile_dir=`` calls :func:`capture_trace` (on the request's own thread,
so the server keeps serving while the trace runs). With no directory (the
default, as ``PATHWAY_TPU_PROFILE_DIR`` is unset by default in JAX) the
route refuses with a JSON error instead of profiling: traces can be large
and a capture perturbs serving. Each capture writes a Chrome trace
(``trace.json``, readable by Perfetto or ``chrome://tracing``) into a fresh
``<dir>/profile-<pid>-<seq>`` subdirectory. The activities are the CPU,
plus CUDA once the process has a CUDA context (the card is in use), so
the trace names the kernels that ran on the card. Captures serialize on
one lock: ``torch.profiler`` cannot nest, so a second request waits its
turn, and one that meets another profiler session of the process (e.g.
``tools/profile_rag_path.py``'s) is refused with an error.

The profiler's device tracing (kineto's CUPTI client) must be initialised
on the thread that imported torch: a first session started on a request
thread records no kernels (kineto refuses the init there). So a server
that enables the route calls :func:`prepare` on its constructing thread,
which opens and closes one empty session.
"""

from __future__ import annotations

import os
import time

from pathway_tpu_torch.analysis.runtime import make_lock

# one capture at a time; the sequence number keys capture subdirectories
_capture_lock = make_lock("profiling.capture")
_capture_seq = 0

_GUARDED_BY = {"_capture_seq": "_capture_lock"}

# ceiling on a single capture: a fat-fingered ms=3600000 must not pin the
# profiler (and a request thread) for an hour
MAX_CAPTURE_MS = 10_000.0

TRACE_FILE = "trace.json"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    return acts


_prepared = False


def prepare() -> None:
    """Initialise the profiler on the calling thread (once a process): an
    empty session, so that later captures on other threads trace the
    card. Call it from the thread that imported torch."""
    global _prepared
    with _capture_lock:
        if _prepared:
            return
        import torch.profiler

        if not torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.profile(activities=_activities()):
                pass
            _prepared = True


def capture_trace(ms, *, profile_dir: str | None = None, sleep=time.sleep) -> dict:
    """Capture ``ms`` milliseconds (clamped to 1..10,000) of the process's
    CPU and CUDA timeline into a fresh subdirectory of ``profile_dir``;
    returns ``{"trace_dir", "trace", "ms", "activities"}`` or ``{"error":
    ...}``. Never raises: this backs a debug endpoint on a live server.
    ``sleep`` is injectable for tests."""
    if not profile_dir:
        return {
            "error": "profiling disabled: set profile_dir (BaseRestServer(profile_dir=...)) "
                     "to enable /debug/profile",
        }
    try:
        ms_f = float(ms)
    except (TypeError, ValueError):
        return {"error": f"bad ms value: {ms!r}"}
    ms_f = max(1.0, min(ms_f, MAX_CAPTURE_MS))
    global _capture_seq
    with _capture_lock:
        _capture_seq += 1
        trace_dir = os.path.join(profile_dir, f"profile-{os.getpid()}-{_capture_seq:03d}")
        try:
            import torch.profiler

            if torch.autograd.profiler._is_profiler_enabled:
                # a second session would silently end the one running
                return {"error": "another torch.profiler session is active in this process"}
            os.makedirs(trace_dir, exist_ok=True)
            acts = _activities()
            with torch.profiler.profile(activities=acts) as prof:
                sleep(ms_f / 1e3)
            path = os.path.join(trace_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
        except Exception as exc:  # noqa: BLE001 - debug surface, not serving
            return {"error": f"{type(exc).__name__}: {exc}"}
    return {"trace_dir": trace_dir, "trace": path, "ms": ms_f,
            "activities": sorted(a.name for a in acts)}
