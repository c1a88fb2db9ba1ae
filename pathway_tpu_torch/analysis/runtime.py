"""Runtime lock sanitizer (counterpart of ``pathway_tpu/analysis/runtime.py``).

JAX reads ``PATHWAY_TPU_LOCK_SANITIZER`` at each lock's construction; the
port reads no environment variable, so the switch is this module's
setting, :func:`configure` (``enabled=False`` by default, as JAX's flag),
read at the same moment.

The static lock pass proves lexical discipline; this module catches what
lexical analysis cannot — the *dynamic* ordering of lock acquisitions
across threads, and writes that reach a guarded field through code paths
the AST pass does not see (setattr, exec'd helpers, subclasses).

Design constraints, in order:

1. **Compiled out when off.** :func:`make_lock` reads the setting once
   at lock construction and returns a plain ``threading.Lock`` /
   ``RLock`` when the sanitizer is disabled — the serving hot paths pay
   zero wrapper cost by default.
2. **Observe, never interfere.** A sanitized lock blocks exactly like
   the lock it wraps; reports land in a bounded in-process list
   (:func:`reports`), they never raise into the instrumented thread.
3. **Condition-compatible.** ``threading.Condition`` probes its lock for
   ``_release_save`` / ``_acquire_restore`` / ``_is_owned``;
   :class:`SanitizedLock` implements all three with held-set
   bookkeeping, so ``Condition(make_lock(...))`` traces ``wait()``'s
   release/reacquire correctly.

What it detects:

* **lock-order inversion** — a global order graph keyed by lock *name*
  (one name per lock role, e.g. ``decode_server.lock``); acquiring B
  while holding A records the edge A->B, and a thread later acquiring A
  while holding B reports ``order-inversion`` (the classic potential
  deadlock, caught even when the timing never actually deadlocks).
* **unguarded guarded-field write** — :func:`enable` patches
  ``__setattr__`` on every ``@guarded_by`` class
  (``analysis/annotations.py``): assigning a guarded field while the
  declared lock is not held by the writing thread reports
  ``unguarded-write``. Reads and in-place container mutation are the
  static pass's job. The FIRST assignment of a field is initialization
  (construction precedes publication) and exempt; so are instances
  whose lock is a plain stdlib lock (sanitizer-off construction).
"""

from __future__ import annotations

import threading

from pathway_tpu_torch.analysis.annotations import GUARDED_CLASSES

# plain stdlib lock: the sanitizer's own state must never be sanitized
_state_lock = threading.Lock()
_MAX_REPORTS = 1000
_reports: list[dict] = []
# directed acquisition-order edges between lock NAMES:
# (held_name, acquired_name) -> (thread_name, stack-free evidence str)
_order_edges: dict[tuple[str, str], str] = {}
_tls = threading.local()


# the switch JAX reads from PATHWAY_TPU_LOCK_SANITIZER (default off)
_enabled = False


def configure(*, enabled: bool = False) -> None:
    """Set the sanitizer switch. Locks built after this call follow it;
    locks built before keep what they are."""
    global _enabled
    _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


def make_lock(name: str, *, rlock: bool = False):
    """THE lock constructor for the threaded components. Plain
    ``threading.Lock()`` / ``RLock()`` when the sanitizer setting is off
    (read once, at construction); a :class:`SanitizedLock` wrapping the
    same when on. ``name`` identifies the lock's role (not instance) in
    the order graph — e.g. every decode server's admission lock shares
    ``decode_server.lock``."""
    inner = threading.RLock() if rlock else threading.Lock()
    if not enabled():
        return inner
    return SanitizedLock(name, inner)


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def report(kind: str, **detail) -> None:
    """Append one sanitizer finding (bounded; never raises)."""
    with _state_lock:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(
                {"kind": kind, "thread": threading.current_thread().name,
                 **detail}
            )


def reports(kind: str | None = None) -> list[dict]:
    with _state_lock:
        out = list(_reports)
    if kind is not None:
        out = [r for r in out if r["kind"] == kind]
    return out


def reset() -> None:
    """Clear reports AND the accumulated order graph (tests isolate
    scenarios with this)."""
    with _state_lock:
        _reports.clear()
        _order_edges.clear()


class SanitizedLock:
    """Lock wrapper recording per-thread held sets and acquisition-order
    edges. Delegates blocking semantics to the wrapped lock."""

    __slots__ = ("name", "_inner", "_owner", "_count")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        self._owner: int | None = None  # thread ident; None = unheld
        self._count = 0  # re-entrant depth (RLock inner)

    # ------------------------------------------------------- bookkeeping
    def _check_order(self) -> None:
        me = threading.current_thread().name
        for held in _held():
            if held is self:
                return  # re-entrant acquire: no new edge
            edge = (held.name, self.name)
            rev = (self.name, held.name)
            with _state_lock:
                first = _order_edges.setdefault(edge, me)
                rev_holder = _order_edges.get(rev)
            if rev_holder is not None and held.name != self.name:
                report(
                    "order-inversion",
                    first=held.name, second=self.name,
                    reverse_seen_in=rev_holder,
                )

    def _note_acquire(self) -> None:
        ident = threading.get_ident()
        if self._owner == ident:
            self._count += 1
        else:
            self._owner = ident
            self._count = 1
        _held().append(self)

    def _note_release(self) -> None:
        stack = _held()
        if self in stack:
            # remove the innermost occurrence (re-entrant stacks)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    break
        if self._owner == threading.get_ident():
            self._count -= 1
            if self._count <= 0:
                self._owner = None
                self._count = 0

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    # ---------------------------------------------------- lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquire()
        return got

    def release(self) -> None:
        self._note_release()
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # ------------------------------------- threading.Condition protocol
    def _release_save(self):
        self._note_release()
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        self._check_order()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._note_acquire()

    def _is_owned(self) -> bool:
        return self.held_by_current_thread()

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.name!r} wrapping {self._inner!r}>"


def _resolve_lock(obj, lock_attr: str):
    """The lock object guarding ``obj``'s fields: the attribute itself,
    or — when the attribute is a ``Condition`` — its underlying lock."""
    lock = getattr(obj, lock_attr, None)
    inner = getattr(lock, "_lock", None)  # threading.Condition wraps
    if inner is not None and not isinstance(lock, SanitizedLock):
        return inner
    return lock


_patched: dict[type, object] = {}


def enable() -> None:
    """Install the guarded-field write check on every ``@guarded_by``
    class registered so far. Idempotent; :func:`disable` undoes it.
    Locks must additionally be built through :func:`make_lock` with the
    setting on for held-set tracking to exist."""
    for cls in GUARDED_CLASSES:
        if cls in _patched:
            continue
        guarded = cls.__graft_guarded_by__
        orig = cls.__setattr__

        def checked_setattr(self, attr, value, _g=guarded, _orig=orig):
            lock_attr = _g.get(attr)
            # first assignment of a field is initialization (typically
            # __init__, possibly after the lock attribute already
            # exists) — only RE-assignment of a published field must
            # hold the lock
            if lock_attr is not None and attr in getattr(self, "__dict__", ()):
                lock = _resolve_lock(self, lock_attr)
                # a missing or un-sanitized lock means construction (or
                # a sanitizer-off instance) — only live SanitizedLocks
                # can prove "not held"
                if (
                    isinstance(lock, SanitizedLock)
                    and not lock.held_by_current_thread()
                ):
                    report(
                        "unguarded-write",
                        cls=type(self).__name__, field=attr,
                        lock=lock.name,
                    )
            _orig(self, attr, value)

        cls.__setattr__ = checked_setattr
        _patched[cls] = orig


def disable() -> None:
    """Remove the write checks installed by :func:`enable`."""
    for cls, orig in _patched.items():
        cls.__setattr__ = orig
    _patched.clear()
