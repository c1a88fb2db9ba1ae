"""Global commit clock + heartbeat kick.

One monotone, process-wide source of engine times (reference:
``Timestamp::new_from_current_time``, even-valued — src/engine/time.rs).
Lives in ``engine`` (not ``io``) so interior operators that emit at fresh
times — deferred UDF drains, temporal flushes — share the same clock as
the connectors without an io import cycle.

The *kick* lets those interior emitters wake every idle connector's
heartbeat immediately: an injected result is only processable once every
live source's frontier passes its time, and an idle source would
otherwise advance only on its (500ms) heartbeat cadence.
"""

from __future__ import annotations

import threading
import time as time_mod

_time_lock = threading.Lock()
_last_time = [0]


def next_commit_time() -> int:
    """Monotonic even commit time shared by all connectors and interior
    emitters."""
    with _time_lock:
        t = int(time_mod.time() * 1000) * 2
        if t <= _last_time[0]:
            t = _last_time[0] + 2
        _last_time[0] = t
        return t


_kick_cond = threading.Condition()
_kick_gen = 0


def kick_heartbeats() -> None:
    """Wake every heartbeat waiter now (deferred results are parked behind
    idle sources' frontiers)."""
    global _kick_gen
    with _kick_cond:
        _kick_gen += 1
        _kick_cond.notify_all()


def wait_heartbeat(last_gen: int, timeout: float) -> int:
    """Block until a kick arrives (generation changes) or ``timeout``
    elapses; returns the current generation to pass back next call."""
    with _kick_cond:
        if _kick_gen == last_gen:
            _kick_cond.wait(timeout)
        return _kick_gen
