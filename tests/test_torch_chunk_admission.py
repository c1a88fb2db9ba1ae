"""The port's admission kill switches (JAX's
``tests/test_chunk_admission.py`` cases): ``batch_admit``,
``prefill_overlap``, ``chunk_autotune``, ``chunked_prefill`` and
``eager_refill`` each change scheduling only. A burst through the
continuous ``DecoderChat`` with the switch on and with it off gives
streams equal to the port's static ``generate`` on the same params (f32 on
the CPU, tiny decoder, dense pool); the ``batch_admit`` on-arm reaches
``pool_admit_batch`` and the off-arm never does. JAX's switches are
``PATHWAY_TPU_*`` flags; the port's are ``DecoderChat`` arguments."""

import pytest
import torch

from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                        max_position=128, dtype=torch.float32)
# all requests arrive together, so same-bucket admissions group (4 slots
# force slot reuse across the burst too)
PROMPTS = ["hello world", "continuous batching", "abc", "qrs tuv", "slot pool", "zzz"]
NEW = 10


@pytest.fixture(scope="module")
def tparams():
    return TD.init_params(torch.Generator().manual_seed(0), TCFG)


@pytest.fixture(scope="module")
def static_truth(tparams):
    tok = ToyCharTokenizer()
    out = []
    for p in PROMPTS:
        ids = torch.tensor([tok.encode(p)], dtype=torch.int32)
        out.append(TD.generate(tparams, ids, torch.ones_like(ids), TCFG, NEW)[0].tolist())
    return out


class _MutedWake:
    """Swallows ``set``, so a burst enqueues whole before the serving loop
    scans its queue (else the first submit's wake could admit it alone)."""

    def __init__(self, ev):
        self._ev = ev

    def set(self):
        pass

    def clear(self):
        self._ev.clear()

    def wait(self, timeout=None):
        return self._ev.wait(timeout)


def _serve_burst(tparams, **kw):
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(),
                       max_new_tokens=NEW, temperature=0.0, max_prompt_tokens=32,
                       continuous=True, n_slots=4, chunk_steps=8, pipeline_depth=2,
                       device="cpu", **kw)
    try:
        srv = chat.server
        real = srv.wake
        srv.wake = _MutedWake(real)
        try:
            reqs = chat.submit_batch(PROMPTS, max_new_tokens=NEW)
        finally:
            srv.wake = real
            real.set()
        for r in reqs:
            assert r.done.wait(timeout=120)
        return [r.tokens for r in reqs], srv
    finally:
        chat.close()


def test_batch_admit_kill_switch_byte_equality(tparams, static_truth, monkeypatch):
    calls = [0]
    orig = TD.pool_admit_batch

    def probe(params, ids, mask, pool, slots, *a, **k):
        # pool_admit is a one-slot pool_admit_batch: count the grouped ones
        calls[0] += len(slots) > 1
        return orig(params, ids, mask, pool, slots, *a, **k)

    monkeypatch.setattr(TD, "pool_admit_batch", probe)
    got_on, srv = _serve_burst(tparams, batch_admit=True)
    assert srv.batch_admit and calls[0] > 0, "the burst never reached a grouped admission"
    grouped = calls[0]
    got_off, srv = _serve_burst(tparams, batch_admit=False)
    assert not srv.batch_admit and calls[0] == grouped, "the off-arm still grouped"
    assert got_on == got_off == static_truth


@pytest.mark.parametrize("switch,extra", [
    ("prefill_overlap", {}),
    ("chunk_autotune", {}),
    ("chunked_prefill", {"prefill_chunk": 8}),  # the longer prompts split
    ("eager_refill", {}),
])
def test_kill_switch_equivalence(tparams, static_truth, switch, extra):
    got_on, srv = _serve_burst(tparams, **{switch: True}, **extra)
    assert getattr(srv, switch) is True
    got_off, srv = _serve_burst(tparams, **{switch: False}, **extra)
    assert getattr(srv, switch) is False
    assert got_on == got_off == static_truth


def test_admission_switches_default_on_as_jax():
    from pathway_tpu.internals.config import _REGISTRY_BY_ENV

    for env, name in (("PATHWAY_TPU_BATCH_ADMIT", "batch_admit"),
                      ("PATHWAY_TPU_PREFILL_OVERLAP", "prefill_overlap")):
        assert _REGISTRY_BY_ENV[env].default is True
    chat = DecoderChat(params=TD.init_params(torch.Generator().manual_seed(1), TCFG), cfg=TCFG,
                       tokenizer=ToyCharTokenizer(), max_new_tokens=2, continuous=True,
                       n_slots=2, device="cpu")
    chat.close()
    assert chat.server.batch_admit and chat.server.prefill_overlap
