"""SLO burn-rate watchdog, the degradation ladder and the tenant scheduler
(counterpart of ``pathway_tpu/engine/slo.py``).

An :class:`Objective` declares a promise (``ttft_p95_ms <= 500``,
``occupancy >= 0.4``); the :class:`SloWatchdog` samples each objective on
every :meth:`~SloWatchdog.tick`, classifies the sample as inside or
outside the promise, and computes error-budget burn rates over two
windows, fast (60 s) and slow (600 s): ``burn = violating fraction /
budget``. An objective's alert fires when both windows burn at or above
the threshold and clears when the fast window recovers. Transitions go to
the registry of ``engine/probes.py`` (``slo_alert``, ``slo_breaches``,
``slo_burn_rate``).

The :class:`DegradationController` climbs one level per ``step_s`` while
any objective alerts and walks back down at the same cadence; the decode
server reads its level every loop tick (level 1 clamps ``max_new``, 2
turns speculative decode off, 3 sheds priority-0 admissions).

The :class:`TenantScheduler` is the ladder's peer for a multi-tenant
server (``DecoderChat(tenant_sched=True)``): it picks which tenant's
queued request admits next (stride scheduling over per-tenant weights)
and holds each tenant to an in-flight token budget, which the server
enforces by preemption.

:func:`configure` takes the place of the ``PATHWAY_TPU_SLO_*`` flags with
their defaults: every threshold 0, so no objective is declared and the
watchdog never alerts. Clocks are injectable, so the state machines are
testable on a synthetic trace with no sleeping.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

from pathway_tpu_torch.engine import probes


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative service-level objective.

    ``kind`` is ``ceiling`` (healthy while ``value <= threshold``, e.g. a
    latency) or ``floor`` (healthy while ``value >= threshold``, e.g.
    occupancy). ``sample`` returns the current value, or None while the
    signal has no data; unsampled ticks spend no budget."""

    name: str
    kind: str  # "ceiling" | "floor"
    threshold: float
    sample: Callable[[], float | None] | None = None
    unit: str = ""

    def violated(self, value: float) -> bool:
        if self.kind == "floor":
            return value < self.threshold
        return value > self.threshold


# ---- built-in signal samplers ---------------------------------------- #

def _ttft_p95_ms() -> float | None:
    s = probes.REGISTRY.hist_summary("ttft_seconds")
    return None if s is None else s["p95"] * 1e3


def _e2e_p95_ms() -> float | None:
    s = probes.REGISTRY.hist_summary("e2e_seconds")
    return None if s is None else s["p95"] * 1e3


def _occupancy() -> float | None:
    per_server = probes.REGISTRY.labelled("serving_occupancy", "server", kind="gauge")
    if not per_server:
        return None
    return sum(per_server.values()) / len(per_server)


def _prefix_hit_rate() -> float | None:
    stats = probes.prefix_stats()
    if not stats["counts"].get("requests"):
        return None
    return stats["hit_rate"]


class SloWatchdog:
    """Rolling-window burn-rate evaluator over a set of objectives."""

    def __init__(
        self,
        objectives: list[Objective],
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        burn_threshold: float = 1.0,
        budget: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.objectives = {o.name: o for o in objectives}
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.budget = max(float(budget), 1e-9)
        self.clock = clock
        self._lock = threading.Lock()
        # name -> deque[(t, violated)], capped so a hammering scraper
        # cannot grow memory without bound
        self._samples: dict[str, collections.deque] = {
            name: collections.deque(maxlen=4096) for name in self.objectives}
        self._values: dict[str, float] = {}
        self._alerts: dict[str, bool] = {name: False for name in self.objectives}
        self._breaches: dict[str, int] = {name: 0 for name in self.objectives}
        self._last_tick: float = float("-inf")

    # ------------------------------------------------------------ write
    def tick(self, now: float | None = None) -> dict:
        """Sample every objective and advance the state machine; returns
        :meth:`state`."""
        values = {}
        for name, obj in self.objectives.items():
            if obj.sample is None:
                continue
            v = obj.sample()
            if v is not None:
                values[name] = v
        return self.observe(values, now)

    def maybe_tick(self, min_interval_s: float = 1.0) -> None:
        """A tick rate-limited to one per ``min_interval_s``, so
        concurrent scrapers do not multiply budget-window samples."""
        now = self.clock()
        with self._lock:
            if now - self._last_tick < min_interval_s:
                return
            self._last_tick = now
        self.tick(now)

    def observe(self, values: dict, now: float | None = None) -> dict:
        """Feed one sample per objective (synthetic traces call this
        directly), update burn rates and alert state, export them."""
        if now is None:
            now = self.clock()
        transitions: list[tuple[str, bool]] = []
        burns: dict[str, tuple[float, float]] = {}
        with self._lock:
            for name, obj in self.objectives.items():
                if name not in values:
                    continue
                v = float(values[name])
                self._values[name] = v
                self._samples[name].append((now, obj.violated(v)))
            for name in self.objectives:
                fast = self._burn_locked(name, now, self.fast_window_s)
                slow = self._burn_locked(name, now, self.slow_window_s)
                burns[name] = (fast, slow)
                if not self._alerts[name]:
                    if fast >= self.burn_threshold and slow >= self.burn_threshold:
                        self._alerts[name] = True
                        self._breaches[name] += 1
                        transitions.append((name, True))
                elif fast < self.burn_threshold:
                    self._alerts[name] = False
                    transitions.append((name, False))
        reg = probes.REGISTRY
        for name, (fast, slow) in burns.items():
            reg.gauge_set("slo_burn_rate", fast, objective=name, window="fast")
            reg.gauge_set("slo_burn_rate", slow, objective=name, window="slow")
        for name, firing in transitions:
            reg.gauge_set("slo_alert", 1.0 if firing else 0.0, objective=name)
            if firing:
                reg.counter_add("slo_breaches", objective=name)
        return self.state()

    def _burn_locked(self, name: str, now: float, window: float) -> float:
        """Burn rate of ``name`` over the last ``window`` seconds; the
        caller holds ``_lock``."""
        cutoff = now - window
        n = bad = 0
        for t, violated in reversed(self._samples[name]):
            if t < cutoff:
                break
            n += 1
            bad += violated
        if not n:
            return 0.0
        return (bad / n) / self.budget

    # ------------------------------------------------------------- read
    def state(self) -> dict:
        """Per-objective alert and burn view plus the aggregate
        ``breaches``: the ``slo`` section of ``probes.unified_snapshot``."""
        with self._lock:
            now = self.clock()
            out: dict = {"objectives": {}, "alerting": [], "breaches": 0}
            for name, obj in self.objectives.items():
                fast = self._burn_locked(name, now, self.fast_window_s)
                slow = self._burn_locked(name, now, self.slow_window_s)
                firing = self._alerts[name]
                out["objectives"][name] = {
                    "kind": obj.kind,
                    "threshold": obj.threshold,
                    "unit": obj.unit,
                    "value": self._values.get(name),
                    "burn_fast": round(fast, 4),
                    "burn_slow": round(slow, 4),
                    "alert": firing,
                    "breaches": self._breaches[name],
                }
                if firing:
                    out["alerting"].append(name)
                out["breaches"] += self._breaches[name]
            out["enabled"] = bool(self.objectives)
            return out


class DegradationController:
    """SLO-driven degradation ladder over the watchdog's alert state.

    While any objective alerts, :meth:`evaluate` climbs one level per
    ``step_s`` seconds; while none alert it walks back down at the same
    cadence, so a blip costs at most one step. The decode server's
    admission reads the level:

    * **0** — full service.
    * **1** — each admission's ``max_new`` clamped to half the server
      default.
    * **2** — also speculative decode off (same tokens, less compute).
    * **3** — also admissions with ``priority <= 0`` shed.

    Transitions go to the ``degradation_level`` gauge."""

    MAX_LEVEL = 3

    def __init__(self, watchdog: SloWatchdog, *, step_s: float = 5.0,
                 clock: Callable[[], float] | None = None):
        self.watchdog = watchdog
        self.step_s = float(step_s)
        self.clock = clock if clock is not None else watchdog.clock
        self._lock = threading.Lock()
        self._level = 0
        self._last_change = float("-inf")
        self._last_eval = float("-inf")

    def level(self) -> int:
        with self._lock:
            return self._level

    def evaluate(self, now: float | None = None) -> int:
        """Advance the ladder against the watchdog's alert state (at most
        one level per ``step_s``) and return the level."""
        if now is None:
            now = self.clock()
        alerting = bool(self.watchdog.state()["alerting"])
        changed = None
        with self._lock:
            if now - self._last_change >= self.step_s:
                if alerting and self._level < self.MAX_LEVEL:
                    self._level += 1
                    self._last_change = now
                    changed = self._level
                elif not alerting and self._level > 0:
                    self._level -= 1
                    self._last_change = now
                    changed = self._level
            lvl = self._level
        if changed is not None:
            probes.REGISTRY.gauge_set("degradation_level", float(changed))
        return lvl

    def maybe_evaluate(self, min_interval_s: float = 1.0) -> int:
        """:meth:`evaluate` rate-limited for the serving loop: between
        evaluations a tick costs one clock read and one lock."""
        now = self.clock()
        with self._lock:
            if now - self._last_eval < min_interval_s:
                return self._level
            self._last_eval = now
        return self.evaluate(now)


class TenantScheduler:
    """Weighted-fair multi-tenant admission (stride scheduling) with
    per-tenant in-flight token budgets.

    The scheduler holds no requests: the server keeps its one queue and
    asks :meth:`select` which entry to pop. Each tenant carries a virtual
    time that advances by ``cost / weight`` per selection; the pop takes
    the FIFO-oldest entry of the waiting tenant with the smallest virtual
    time, so service is proportional to weight and every tenant with a
    positive weight is served eventually. A tenant seen for the first time
    (or back from idle) enters at the floor, the virtual time of the last
    selection: idle history grants no burst credit.

    ``budget_tokens > 0`` makes a tenant holding that many decode tokens
    in flight ineligible; a tenant with nothing in flight is always
    eligible, so the budget cannot deadlock admission. The server escalates
    to preemption when an eligible tenant waits with no free slot while an
    over-budget tenant holds one."""

    def __init__(self, *, weights: dict[str, float] | None = None,
                 budget_tokens: int = 0,
                 clock: Callable[[], float] | None = None):
        self.budget_tokens = int(budget_tokens)
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._weights = {str(k): float(v)
                         for k, v in (weights or {}).items() if float(v) > 0}
        self._vtime: dict[str, float] = {}
        self._floor = 0.0
        self._inflight: dict[str, int] = {}
        self._last_served: dict[str, float] = {}

    @staticmethod
    def parse_weights(spec: str) -> dict[str, float]:
        """``"prod:4,batch:1"`` -> ``{"prod": 4.0, "batch": 1.0}``; malformed
        or non-positive pairs are skipped, never raised on."""
        out: dict[str, float] = {}
        for part in (spec or "").split(","):
            name, _, w = part.strip().partition(":")
            name = name.strip()
            if not name or not w:
                continue
            try:
                val = float(w)
            except ValueError:
                continue
            if val > 0:
                out[name] = val
        return out

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def charge(self, tenant: str, tokens: int) -> None:
        """A request of ``tenant`` entered a slot with ``tokens`` of decode
        budget."""
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + int(tokens)

    def credit(self, tenant: str, tokens: int) -> None:
        """The request left its slot (drained, failed, shed or preempted)."""
        with self._lock:
            left = self._inflight.get(tenant, 0) - int(tokens)
            if left > 0:
                self._inflight[tenant] = left
            else:
                self._inflight.pop(tenant, None)

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def _over(self, tenant: str) -> bool:
        held = self._inflight.get(tenant, 0)
        return self.budget_tokens > 0 and held > 0 and held >= self.budget_tokens

    def over_budget(self, tenant: str) -> bool:
        """At or over the in-flight budget (and holding tokens)."""
        with self._lock:
            return self._over(tenant)

    def select(self, entries, charge: bool = True) -> int | None:
        """The index of the next entry to admit from ``entries``
        (FIFO-ordered ``(tenant, cost)`` pairs), or None when every waiting
        tenant is over budget. ``charge=False`` peeks without advancing
        virtual time (the preemption check)."""
        first: dict[str, int] = {}
        cost: dict[str, int] = {}
        for i, (tenant, c) in enumerate(entries):
            if tenant not in first:
                first[tenant] = i
                cost[tenant] = int(c)
        if not first:
            return None
        with self._lock:
            best = None
            for tenant in first:
                if self._over(tenant):
                    continue
                vt = max(self._vtime.get(tenant, self._floor), self._floor)
                if best is None or (vt, tenant) < best[:2]:
                    best = (vt, tenant, first[tenant])
            if best is None:
                return None
            vt, tenant, idx = best
            if charge:
                self._floor = max(self._floor, vt)
                self._vtime[tenant] = vt + max(cost[tenant], 1) / self.weight(tenant)
                self._last_served[tenant] = self.clock()
        return idx

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_tokens": self.budget_tokens,
                "weights": dict(self._weights),
                "inflight": dict(self._inflight),
                "vtime": {k: round(v, 4) for k, v in self._vtime.items()},
            }


# --------------------------------------------------------------------- #
# configured module singletons

_settings = dict(ttft_p95_ms=0.0, e2e_p95_ms=0.0, occupancy_min=0.0,
                 prefix_hit_min=0.0, window_fast_s=60.0, window_slow_s=600.0,
                 burn_threshold=1.0, budget=0.1)
_watchdog: SloWatchdog | None = None
_degradation: DegradationController | None = None
_watchdog_lock = threading.Lock()


def configure(ttft_p95_ms: float = 0.0, e2e_p95_ms: float = 0.0,
              occupancy_min: float = 0.0, prefix_hit_min: float = 0.0,
              window_fast_s: float = 60.0, window_slow_s: float = 600.0,
              burn_threshold: float = 1.0, budget: float = 0.1) -> None:
    """Declare the objectives (a threshold of 0 leaves one out) and the
    windows, threshold and budget; the defaults are the JAX flag
    defaults. Drops the singletons, so the next :func:`get_watchdog`
    builds from these settings; servers built earlier keep theirs."""
    _settings.update(
        ttft_p95_ms=float(ttft_p95_ms), e2e_p95_ms=float(e2e_p95_ms),
        occupancy_min=float(occupancy_min), prefix_hit_min=float(prefix_hit_min),
        window_fast_s=float(window_fast_s), window_slow_s=float(window_slow_s),
        burn_threshold=float(burn_threshold), budget=float(budget))
    reset_watchdog()


def default_objectives() -> list[Objective]:
    """The objectives :func:`configure` declared."""
    s = _settings
    out: list[Objective] = []
    if s["ttft_p95_ms"] > 0:
        out.append(Objective("ttft_p95", "ceiling", s["ttft_p95_ms"],
                             sample=_ttft_p95_ms, unit="ms"))
    if s["e2e_p95_ms"] > 0:
        out.append(Objective("e2e_p95", "ceiling", s["e2e_p95_ms"],
                             sample=_e2e_p95_ms, unit="ms"))
    if s["occupancy_min"] > 0:
        out.append(Objective("occupancy", "floor", s["occupancy_min"],
                             sample=_occupancy))
    if s["prefix_hit_min"] > 0:
        out.append(Objective("prefix_hit_rate", "floor", s["prefix_hit_min"],
                             sample=_prefix_hit_rate))
    return out


def get_watchdog() -> SloWatchdog:
    """The configured singleton, built at first use."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            s = _settings
            _watchdog = SloWatchdog(
                default_objectives(), fast_window_s=s["window_fast_s"],
                slow_window_s=s["window_slow_s"],
                burn_threshold=s["burn_threshold"], budget=s["budget"])
        return _watchdog


def get_degradation_controller() -> DegradationController:
    """The ladder over :func:`get_watchdog`, shared by every server so all
    admission paths degrade in lockstep."""
    global _degradation
    wd = get_watchdog()
    with _watchdog_lock:
        if _degradation is None or _degradation.watchdog is not wd:
            _degradation = DegradationController(wd)
        return _degradation


def reset_watchdog() -> None:
    global _watchdog, _degradation
    with _watchdog_lock:
        _watchdog = None
        _degradation = None
    probes.REGISTRY.remove("slo_burn_rate", "slo_alert", "slo_breaches",
                           "degradation_level")


def slo_snapshot(tick: bool = True) -> dict:
    """The ``slo`` section of ``probes.unified_snapshot``. Each snapshot
    advances the rolling windows (at most once a second), so a server
    that is only watched is also judged."""
    wd = get_watchdog()
    if tick and wd.objectives:
        wd.maybe_tick()
    return wd.state()


def burn_signals(state: dict) -> dict:
    """Per-objective ``(burn_fast, burn_slow)`` pairs of a watchdog state
    (a local :meth:`SloWatchdog.state` or the same dict scraped as JSON)."""
    out: dict = {}
    for name, obj in ((state or {}).get("objectives") or {}).items():
        try:
            out[str(name)] = (float(obj.get("burn_fast") or 0.0),
                              float(obj.get("burn_slow") or 0.0))
        except (AttributeError, TypeError, ValueError):
            continue
    return out


def max_burn(state: dict) -> float:
    """The largest ``min(burn_fast, burn_slow)`` over objectives: both
    windows must burn for an objective to count, the alert's AND rule."""
    signals = burn_signals(state)
    if not signals:
        return 0.0
    return max(min(fast, slow) for fast, slow in signals.values())
