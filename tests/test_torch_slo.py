"""The port's SLO watchdog and degradation ladder against the JAX package
(after tests/test_slo.py and the ladder case of tests/test_chaos.py).

The same synthetic traces, on injected clocks, go through the JAX and the
port ``SloWatchdog`` / ``DegradationController``: states (values, burn
rates, alerts, breaches), registry exports and ladder levels must be
equal at every tick. ``slo.configure`` stands in for the
``PATHWAY_TPU_SLO_*`` flags; ``probes.unified_snapshot`` carries the
watchdog's state as its ``slo`` section.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import pathway_tpu  # noqa: F401 - flag registry import order
from pathway_tpu.engine import probes as jprobes
from pathway_tpu.engine import slo as jslo
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.engine import slo

FAMILIES = ("slo_burn_rate", "slo_alert", "slo_breaches", "degradation_level")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@pytest.fixture(autouse=True)
def _fresh():
    for reg in (probes.REGISTRY, jprobes.REGISTRY):
        reg.remove(*FAMILIES)
    slo.configure()
    yield
    slo.configure()
    jslo.reset_watchdog()
    for reg in (probes.REGISTRY, jprobes.REGISTRY):
        reg.remove(*FAMILIES)


def _pair(objectives, **kw):
    """(port, JAX) watchdogs over the same objectives, each on its own
    fake clock at the same time."""
    out = []
    for mod in (slo, jslo):
        clock = FakeClock()
        objs = [mod.Objective(name, kind, thr, unit=unit)
                for name, kind, thr, unit in objectives]
        out.append((mod.SloWatchdog(objs, clock=clock, **kw), clock))
    return out


def _exports(reg) -> dict:
    snap = reg.snapshot()
    return {kind: {n: snap[kind].get(n) for n in FAMILIES}
            for kind in ("counters", "gauges")}


def test_objective_kinds():
    for mod in (slo, jslo):
        ceil = mod.Objective("lat", "ceiling", 500.0)
        assert not ceil.violated(500.0) and ceil.violated(500.1)
        floor = mod.Objective("occ", "floor", 0.4)
        assert not floor.violated(0.4) and floor.violated(0.39)


TRACE_OBJECTIVES = [("ttft_p95", "ceiling", 500.0, "ms"),
                    ("occupancy", "floor", 0.4, "")]


def _trace(seed: int):
    """Healthy, a cliff long enough to fill both windows, a gap with no
    samples, recovery, then random flapping: (dt, values) per tick."""
    rng = np.random.default_rng(seed)
    steps = [(10.0, {"ttft_p95": 120.0, "occupancy": 0.8})] * 60
    steps += [(10.0, {"ttft_p95": 900.0, "occupancy": 0.2})] * 13
    steps += [(30.0, {})] * 3
    steps += [(10.0, {"ttft_p95": 110.0})] * 8
    for _ in range(80):
        vals = {}
        if rng.random() < 0.8:
            vals["ttft_p95"] = float(rng.choice([100.0, 700.0]))
        if rng.random() < 0.5:
            vals["occupancy"] = float(rng.uniform(0.0, 1.0))
        steps.append((float(rng.choice([1.0, 10.0, 45.0])), vals))
    return steps


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, dict(fast_window_s=30.0, slow_window_s=120.0,
                                         burn_threshold=2.0, budget=0.25)])
def test_watchdog_states_equal_jax_on_a_trace(seed, kw):
    (port, pclock), (jax_wd, jclock) = _pair(TRACE_OBJECTIVES, **kw)
    fired = 0
    for dt, values in _trace(seed):
        got = port.observe(values, pclock.advance(dt))
        want = jax_wd.observe(values, jclock.advance(dt))
        assert got == want
        assert port.state() == jax_wd.state()
        assert slo.burn_signals(got) == jslo.burn_signals(want)
        assert slo.max_burn(got) == jslo.max_burn(want)
        assert _exports(probes.REGISTRY) == _exports(jprobes.REGISTRY)
        fired = max(fired, got["breaches"])
    assert fired >= 2  # the cliff and the flapping both alerted


def test_burn_rate_state_machine_breach_alert_recover():
    """tests/test_slo.py's trace on the port: no alert before the slow
    window confirms, one breach, a recovery that clears the alert."""
    (wd, clock), _ = _pair([("ttft_p95", "ceiling", 500.0, "ms")])
    for _ in range(60):
        state = wd.observe({"ttft_p95": 120.0}, clock.advance(10.0))
    assert state["objectives"]["ttft_p95"]["burn_fast"] == 0.0
    for _ in range(6):
        state = wd.observe({"ttft_p95": 900.0}, clock.advance(10.0))
    obj = state["objectives"]["ttft_p95"]
    assert obj["burn_fast"] >= wd.burn_threshold and not obj["alert"]
    for _ in range(6):
        state = wd.observe({"ttft_p95": 900.0}, clock.advance(10.0))
    assert state["alerting"] == ["ttft_p95"] and state["breaches"] == 1
    assert probes.REGISTRY.gauge_value("slo_alert", objective="ttft_p95") == 1.0
    for _ in range(7):
        state = wd.observe({"ttft_p95": 110.0}, clock.advance(10.0))
    assert state["alerting"] == [] and state["breaches"] == 1
    assert probes.REGISTRY.gauge_value("slo_alert", objective="ttft_p95") == 0.0


def test_unsampled_objectives_burn_nothing():
    (wd, clock), _ = _pair([("ttft_p95", "ceiling", 500.0, "ms")])
    for _ in range(20):
        state = wd.observe({}, clock.advance(10.0))
    obj = state["objectives"]["ttft_p95"]
    assert obj["burn_fast"] == 0.0 and not obj["alert"] and obj["value"] is None


def test_maybe_tick_rate_limited():
    clock, calls = FakeClock(), []
    wd = slo.SloWatchdog([slo.Objective("sig", "ceiling", 1.0,
                                        sample=lambda: calls.append(1) or 0.5)],
                         clock=clock)
    for _ in range(10):
        wd.maybe_tick(min_interval_s=1.0)
    assert len(calls) == 1
    clock.advance(1.5)
    for _ in range(10):
        wd.maybe_tick(min_interval_s=1.0)
    assert len(calls) == 2


def _alert_trace():
    """(dt, alerting) per evaluation: climb past the top, rate-limited
    steps, recovery to 0, a blip."""
    steps = [(0.0, True), (0.0, True), (2.0, True), (5.0, True), (5.0, True),
             (5.0, True), (1.0, True), (5.0, False), (4.9, False), (0.2, False),
             (5.0, False), (5.0, False), (5.0, False), (5.0, True), (5.0, False),
             (10.0, True), (3.0, True), (2.0, True), (60.0, False)]
    return steps


@pytest.mark.parametrize("step_s", [5.0, 0.0])
def test_ladder_levels_equal_jax(step_s):
    """The ladder over a scripted alert state, both packages: equal levels
    and ``degradation_level`` gauges after every evaluation."""
    ladders = []
    for mod in (slo, jslo):
        clock = FakeClock()
        wd = SimpleNamespace(state=None, clock=clock)
        ladders.append((mod.DegradationController(wd, step_s=step_s, clock=clock),
                        wd, clock))
    levels = []
    for dt, alerting in _alert_trace():
        got = []
        for ctl, wd, clock in ladders:
            clock.advance(dt)
            state = {"alerting": ["ttft_p95"] if alerting else []}
            wd.state = lambda state=state: state
            got.append((ctl.evaluate(), ctl.level()))
        assert got[0] == got[1]
        assert probes.REGISTRY.gauge_value("degradation_level") == \
            jprobes.REGISTRY.gauge_value("degradation_level")
        levels.append(got[0][0])
    assert max(levels) == slo.DegradationController.MAX_LEVEL == 3
    assert 0 in levels[levels.index(3):]  # and all the way back down


def test_ladder_over_a_watchdog_with_maybe_evaluate():
    """A real watchdog behind the ladder, both packages: an objective that
    always fails climbs one level per step; ``maybe_evaluate`` is rate
    limited to once a second."""
    (pwd, pclock), (jwd, jclock) = _pair([("ttft_p95", "ceiling", 500.0, "ms")])
    ctls = [slo.DegradationController(pwd, step_s=5.0),
            jslo.DegradationController(jwd, step_s=5.0)]
    for i in range(40):
        vals = {"ttft_p95": 900.0 if i < 25 else 100.0}
        lv = []
        for wd, clock, ctl in ((pwd, pclock, ctls[0]), (jwd, jclock, ctls[1])):
            wd.observe(vals, clock.advance(2.5))
            lv.append((ctl.maybe_evaluate(), ctl.maybe_evaluate(min_interval_s=10.0)))
        assert lv[0] == lv[1]
    assert ctls[0].level() == ctls[1].level()


def test_configure_builds_the_singleton_as_the_flags_do(monkeypatch):
    assert slo.slo_snapshot() == {"objectives": {}, "alerting": [], "breaches": 0,
                                  "enabled": False}
    slo.configure(ttft_p95_ms=500, occupancy_min=0.4, window_fast_s=30,
                  burn_threshold=2.0)
    for var, v in (("TTFT_P95_MS", "500"), ("OCCUPANCY_MIN", "0.4"),
                   ("WINDOW_FAST_S", "30"), ("BURN_THRESHOLD", "2.0")):
        monkeypatch.setenv(f"PATHWAY_TPU_SLO_{var}", v)
    jslo.reset_watchdog()
    got, want = slo.get_watchdog(), jslo.get_watchdog()
    assert set(got.objectives) == set(want.objectives) == {"ttft_p95", "occupancy"}
    for name in got.objectives:
        g, w = got.objectives[name], want.objectives[name]
        assert (g.kind, g.threshold, g.unit) == (w.kind, w.threshold, w.unit)
    for attr in ("fast_window_s", "slow_window_s", "burn_threshold", "budget"):
        assert getattr(got, attr) == getattr(want, attr)
    ctl = slo.get_degradation_controller()
    assert ctl.watchdog is got and slo.get_degradation_controller() is ctl
    assert ctl.step_s == jslo.get_degradation_controller().step_s == 5.0
    snap = slo.slo_snapshot()
    assert snap["enabled"] is True and set(snap["objectives"]) == {"ttft_p95", "occupancy"}


def test_samplers_read_the_registry():
    """The built-in samplers read the port's registry as JAX's read its
    own: None before data, then the histogram p95 / gauge mean / hit rate."""
    for reg in (probes.REGISTRY, jprobes.REGISTRY):
        reg.remove("ttft_seconds", "e2e_seconds", "serving_occupancy", "prefix_events")
    for mod_s, mod_p in ((slo, probes), (jslo, jprobes)):
        assert mod_s._ttft_p95_ms() is None and mod_s._occupancy() is None
        assert mod_s._prefix_hit_rate() is None
        for v in (0.01, 0.02, 0.4):
            mod_p.REGISTRY.observe("ttft_seconds", v, phase="decode")
            mod_p.REGISTRY.observe("e2e_seconds", 2 * v, phase="decode")
        mod_p.REGISTRY.gauge_set("serving_occupancy", 0.25, server="a")
        mod_p.REGISTRY.gauge_set("serving_occupancy", 0.75, server="b")
        mod_p.record_prefix("requests", 2)
        mod_p.record_prefix("hit_tokens", 3)
        mod_p.record_prefix("miss_tokens", 1)
    for name in ("_ttft_p95_ms", "_e2e_p95_ms", "_occupancy", "_prefix_hit_rate"):
        assert getattr(slo, name)() == getattr(jslo, name)(), name
    assert slo._occupancy() == 0.5
    for reg in (probes.REGISTRY, jprobes.REGISTRY):
        reg.remove("ttft_seconds", "e2e_seconds", "serving_occupancy", "prefix_events")


def test_slo_section_in_unified_snapshot():
    snap = probes.unified_snapshot()
    assert set(snap) == {"scheduler", "serving", "engine", "hbm", "slo", "tuning", "registry"}
    assert snap["slo"] == slo.slo_snapshot() == jslo.SloWatchdog([]).state()
    # a declared objective is sampled by the snapshot (a scrape judges)
    probes.REGISTRY.remove("ttft_seconds")
    probes.REGISTRY.observe("ttft_seconds", 0.9, phase="decode")
    slo.configure(ttft_p95_ms=500)
    section = probes.unified_snapshot()["slo"]
    obj = section["objectives"]["ttft_p95"]
    assert section["enabled"] and obj["value"] is not None and obj["value"] > 500
    assert section["alerting"] == ["ttft_p95"] and section["breaches"] == 1
    probes.REGISTRY.remove("ttft_seconds")
