"""The port's StageWorker and the tier-2 promotion stage survive a
``BaseException`` raised by the work: the worker goes on serving later
items, and a request whose promotion failed still finishes, with the tokens
of the same trace served without tier 2. Every wait is bounded."""

import threading

import numpy as np
import torch

from pathway_tpu_torch.engine.async_runtime import StageWorker
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.xpacks.llm import DecoderChat
from pathway_tpu_torch.xpacks.llm import llms as L
from tests.utils import ToyCharTokenizer

WAIT = 60.0


class Abort(BaseException):
    """Not an Exception: the kind of failure an ``except Exception`` lets by."""


def test_worker_survives_a_base_exception():
    seen, done = [], threading.Event()

    def fn(item):
        if item == 0:
            raise Abort("first item")
        seen.append(item)
        if item == 3:
            done.set()

    w = StageWorker(fn, maxsize=2, name="test:abort")
    try:
        for i in range(4):
            w.submit(i)
        assert done.wait(WAIT)
        assert seen == [1, 2, 3]
    finally:
        w.close()
    assert not w._thread.is_alive()


TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                        max_position=128, dtype=torch.float32)
B = 8
# six distinct 3-block heads churn a 3-block tier 1; the first head comes
# back (a tier-2 hit whose promotion is asked for), then once more
T2 = [c * 24 + "?" for c in "abcdef"] + ["a" * 24 + "?", "a" * 24 + "!"]


def _serve_t2(params, t2_mb):
    chat = DecoderChat(params=params, cfg=TCFG, tokenizer=ToyCharTokenizer(64),
                       max_new_tokens=8, max_prompt_tokens=32, continuous=True,
                       n_slots=4, chunk_steps=4, pipeline_depth=2, prefill_chunk=B,
                       paged_kv=True, paged_kv_block=B, paged_kernel=True,
                       flash_prefill=True, prefix_cache_mb=0.013, prefix_t2_mb=t2_mb,
                       device="cpu")
    try:
        texts = []
        for p in T2:
            r = chat.submit_batch([p])[0]
            assert r.done.wait(WAIT), f"request {p!r} did not finish"
            texts.append(r.text)
        assert chat.server.t2_drain(timeout=WAIT)
        assert chat.server.failed is None
        return texts, dict(chat.server.stats)
    finally:
        chat.close()


def test_promotion_base_exception_releases_the_request(monkeypatch):
    params = TD.init_params(torch.Generator().manual_seed(3), TCFG)
    off, _ = _serve_t2(params, 0.0)

    def abort(a: np.ndarray, device):
        raise Abort("promotion copy")

    monkeypatch.setattr(L, "_device_blob", abort)
    texts, stats = _serve_t2(params, 0.1)
    assert stats["t2_hit_requests"] >= 1
    assert stats["t2_dropped"] >= 1 and stats["t2_promoted_blocks"] == 0
    assert texts == off
