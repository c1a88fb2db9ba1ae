"""The port's chaos sites, backoff strategy and error log against the JAX
package (after tests/test_chaos.py's harness cases).

* A port ``ChaosSite`` and a JAX ``ChaosSite`` with the same (name, seed,
  rate) fault on the same operation numbers, with the same provenance.
* ``chaos.configure`` stands in for ``PATHWAY_TPU_CHAOS*``: off by default
  (``site`` returns None), a site filter of exact names or dotted
  prefixes, and a configured site's schedule equal to JAX's under the
  same environment.
* ``ExponentialBackoffRetryStrategy.invoke_sync`` sleeps the JAX schedule
  (the jitter seeded alike on both sides) and re-raises the last failure.
"""

import random

import pytest

from pathway_tpu.engine import chaos as jchaos
from pathway_tpu.internals.udfs import retries as jretries
from pathway_tpu_torch.engine import chaos
from pathway_tpu_torch.internals import retries
from pathway_tpu_torch.internals.errors import ErrorLog, get_global_error_log


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.configure()
    yield
    chaos.configure()


def _schedule(site, n=200):
    out = []
    for _ in range(n):
        try:
            site.maybe_fail()
            out.append(0)
        except (chaos.InjectedFault, jchaos.InjectedFault) as exc:
            assert exc.site == site.name and exc.seq == len(out) + 1
            out.append(1)
    return out


@pytest.mark.parametrize("name,seed,rate", [
    ("decode.dispatch", 7, 0.3), ("decode.admit", 0, 0.05), ("embed.h2d", 123, 0.5),
    ("query.tick", 2**31 - 1, 0.01), ("decode.dispatch", 0, 1.0),
])
def test_schedule_equals_jax(name, seed, rate):
    got = _schedule(chaos.ChaosSite(name, rate, seed))
    want = _schedule(jchaos.ChaosSite(name, rate, seed))
    assert got == want and sum(got) > 0
    # deterministic across runs; another site with the same seed differs
    assert _schedule(chaos.ChaosSite(name, rate, seed)) == got
    if rate < 1.0:
        assert _schedule(chaos.ChaosSite(name + ".x", rate, seed)) != got


def test_provenance():
    hot = chaos.ChaosSite("decode.admit", 1.0, 0)
    for seq in (1, 2):
        with pytest.raises(chaos.InjectedFault) as ei:
            hot.maybe_fail()
        assert ei.value.site == "decode.admit" and ei.value.seq == seq
        assert isinstance(ei.value, RuntimeError)
        assert str(ei.value) == f"injected fault at decode.admit (op #{seq})"


def test_kill_switch_and_site_filter(monkeypatch):
    """Off by default; ``sites`` arms exact names or dotted prefixes, an
    empty filter arms all; the same filter arms the same sites as JAX's."""
    assert chaos.site("decode.admit") is None  # default: off
    chaos.configure(rate=0.0, sites="decode")
    assert chaos.site("decode.admit") is None  # rate 0 is off whatever the filter
    spec = "decode, persist.put"
    chaos.configure(rate=0.5, sites=spec)
    monkeypatch.setenv("PATHWAY_TPU_CHAOS", "0.5")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SITES", spec)
    for name in ("decode.admit", "decode.dispatch", "persist.put", "embed.h2d",
                 "decoder.x", "query.tick", "persist"):
        got, want = chaos.site(name), jchaos.site(name)
        assert (got is None) == (want is None), name
    assert chaos.site("decode.admit") is not None      # prefix match
    assert chaos.site("persist.put") is not None       # exact match
    assert chaos.site("embed.h2d") is None             # filtered out
    assert chaos.site("decoder.x") is None             # a prefix is dotted
    chaos.configure(rate=0.5, sites="")
    assert chaos.site("embed.h2d") is not None         # empty spec arms all


def test_configured_site_schedule_equals_jax(monkeypatch):
    chaos.configure(rate=0.2, seed=11, sites="decode.dispatch")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS", "0.2")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SEED", "11")
    monkeypatch.setenv("PATHWAY_TPU_CHAOS_SITES", "decode.dispatch")
    got, want = chaos.site("decode.dispatch"), jchaos.site("decode.dispatch")
    assert got.rate == want.rate == 0.2
    assert _schedule(got) == _schedule(want)
    chaos.configure(rate=7.0)  # clamped to 1, as JAX clamps
    assert chaos.site("x").rate == 1.0


class _Flaky:
    def __init__(self, fails: int):
        self.fails, self.calls = fails, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError(f"attempt {self.calls}")
        return "done"


@pytest.mark.parametrize("fails,max_retries", [(0, 3), (2, 3), (5, 3), (4, 4)])
@pytest.mark.parametrize("kw", [
    dict(initial_delay=20, backoff_factor=2, jitter_ms=10, max_delay_ms=2000),
    dict(initial_delay=20, backoff_factor=2, jitter_ms=10, max_delay_ms=50),
    dict(initial_delay=1000, backoff_factor=2, jitter_ms=300, max_delay_ms=0),
])
def test_backoff_schedule_equals_jax(fails, max_retries, kw):
    def run(mod):
        slept, action = [], _Flaky(fails)
        random.seed(5)
        strategy = mod.ExponentialBackoffRetryStrategy(max_retries=max_retries, **kw)
        try:
            out = strategy.invoke_sync(action, sleep=slept.append)
        except RuntimeError as exc:
            out = str(exc)
        return out, slept, action.calls

    got, want = run(retries), run(jretries)
    assert got == want
    out, slept, calls = got
    assert calls == min(fails, max_retries) + 1
    assert out == ("done" if fails <= max_retries else f"attempt {max_retries + 1}")
    assert len(slept) == min(fails, max_retries)


def test_error_log():
    log = ErrorLog()
    log.log("boom")
    log.log("bang", operator="op")
    assert log.entries == [{"message": "boom", "operator": None},
                           {"message": "bang", "operator": "op"}]
    log.clear()
    assert log.entries == []
    assert get_global_error_log() is get_global_error_log()
