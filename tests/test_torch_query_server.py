"""The port's micro-batched ``QueryServer`` (after the QueryServer cases of
tests/test_rerank_cascade.py and tests/test_chaos.py).

* Coalescing: concurrent requests share ticks (fewer dispatches than
  requests) and each gets the per-call path's answer, which is also the
  JAX pipeline's on the same weights (keys equal up to near ties, as
  tests/test_torch_rag.py holds it).
* Backpressure blocks a submitter at the queue bound until the loop
  drains; shutdown refuses later submits and fails what is queued.
* Supervision: a poisoned ``(kind, k)`` group fails alone; without it the
  first error latches; ``query.tick`` chaos errors each group with
  provenance and the server keeps serving; a thread stuck past its
  shutdown join is counted.

Every wait is bounded and asserted.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.ops.fused_query import FusedRAGPipeline as JPipe
from pathway_tpu_torch import (
    CrossEncoderModel,
    FusedRAGPipeline,
    QueryServer,
    SentenceEmbedderModel,
)
from pathway_tpu_torch.engine import chaos, probes
from pathway_tpu_torch.internals.errors import get_global_error_log
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from tests.test_torch_rag import _corpus, _same_up_to_near_ties
from tests.torch_parity import configs, np_encoder_params, np_head, to_jax

WAIT = 30.0


@pytest.fixture(autouse=True)
def _chaos_off():
    chaos.configure()
    yield
    chaos.configure()


@pytest.fixture(scope="module")
def pipelines():
    jcfg, tcfg = configs("float32")
    e_np = np_encoder_params(seed=60, emb_std=1.0, w_std=0.3)
    r_np, head = np_encoder_params(seed=61, emb_std=1.0, w_std=0.3), np_head(62, 1.0)
    docs, queries = _corpus(seed=6, n_docs=160, n_queries=8)
    kw = dict(reserved_space=256, doc_seq=16, pair_seq=48)
    jtok = JTok(vocab_size=1000)
    jemb = JEmbed(jcfg, params=to_jax(e_np), tokenizer=jtok, max_length=32)
    jp = JPipe(jemb, JCross(jcfg, params=to_jax(r_np), head=to_jax(head),
                            tokenizer=jtok), **kw)
    ttok = HashTokenizer(vocab_size=1000)
    temb = SentenceEmbedderModel(tcfg, params=from_jax_params(e_np), tokenizer=ttok,
                                 max_length=32, device="cpu")
    tp = FusedRAGPipeline(temb, CrossEncoderModel(
        tcfg, params=from_jax_params(r_np), head=from_jax_params(head), tokenizer=ttok,
        device="cpu"), **kw)
    keys = [f"d{i}" for i in range(len(docs))]
    for p in (jp, tp):
        p.add(keys, docs)
    yield jp, tp, queries
    jemb.close()


@pytest.mark.parametrize("rerank,k", [(True, 8), (False, 5)])
def test_coalesces_and_matches_the_per_call_path(pipelines, rerank, k):
    jp, tp, queries = pipelines
    if rerank:
        direct = {q: tp.retrieve_rerank_batch([q], k)[0] for q in queries}
        ref = {q: jp.retrieve_rerank(q, k) for q in queries}
    else:
        direct = {q: tp.retrieve([q], k)[0] for q in queries}
        ref = {q: jp.retrieve([q], k)[0] for q in queries}
    d0 = probes.dispatch_counts()
    with QueryServer(tp, tick_ms=50.0, max_batch=8) as srv:
        assert srv.query(queries[0], k, rerank=rerank, timeout=WAIT)
        with ThreadPoolExecutor(len(queries)) as ex:
            served = list(ex.map(
                lambda q: srv.query(q, k, rerank=rerank, timeout=WAIT), queries))
        stats = srv.stats()
        spans = srv.recent_traces()
    for q, got in zip(queries, served):
        assert [key for key, _ in got] == [key for key, _ in direct[q]]
        _same_up_to_near_ties(ref[q], got)
    assert stats["requests"] == len(queries) + 1 and not stats["failed"]
    # the burst shared ticks: fewer dispatches than requests
    assert stats["dispatches"] < stats["requests"] and max(stats["batch_hist"]) > 1
    assert stats["mean_batch"] == round(stats["requests"] / stats["ticks"], 3)
    kind = "fused_retrieve_rerank" if rerank else "fused_retrieve"
    assert probes.dispatch_counts()[kind] - d0.get(kind, 0) == stats["dispatches"]
    assert len(spans) == len(queries) + 1
    for s in spans:
        assert [e["name"] for e in s["events"]] == ["enqueue", "admit", "drain"]
        assert s["attrs"]["query_kind"] == ("rerank" if rerank else "retrieve")


def test_mixed_groups_dispatch_once_each(pipelines):
    """A tick with two (kind, k) groups makes exactly two pipeline calls."""
    _, tp, queries = pipelines
    calls = []

    class Counting:
        reranker = tp.reranker

        def retrieve(self, texts, k):
            calls.append(("retrieve", k, len(texts)))
            return tp.retrieve(texts, k)

        def retrieve_rerank_batch(self, texts, k):
            calls.append(("rerank", k, len(texts)))
            return tp.retrieve_rerank_batch(texts, k)

    with QueryServer(Counting(), tick_ms=200.0, max_batch=6) as srv:
        reqs = [srv.submit(q, 4, rerank=i % 2 == 0) for i, q in enumerate(queries[:6])]
        for r in reqs:
            assert len(r.wait(WAIT)) == 4
    assert sorted(calls) == [("rerank", 4, 3), ("retrieve", 4, 3)]


class _BlockingPipe:
    reranker = None

    def __init__(self):
        self.release = threading.Event()

    def retrieve(self, texts, k):
        assert self.release.wait(WAIT)
        return [[t] for t in texts]


def test_backpressure_and_shutdown():
    pipe = _BlockingPipe()
    srv = QueryServer(pipe, tick_ms=1.0, max_batch=1, queue_bound=1)
    try:
        first = srv.submit("a", 1)   # the loop takes it into a blocked tick
        time.sleep(0.1)
        second = srv.submit("b", 1)  # fills the queue
        third = []
        t = threading.Thread(target=lambda: third.append(srv.submit("c", 1)))
        t.start()
        t.join(0.3)
        assert t.is_alive(), "a submit past the queue bound must block"
        pipe.release.set()
        t.join(WAIT)
        assert not t.is_alive()
        assert [r.wait(WAIT) for r in (first, second, third[0])] == [["a"], ["b"], ["c"]]
    finally:
        pipe.release.set()
        srv.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit("d", 1)
    with QueryServer(pipe) as qs, pytest.raises(ValueError, match="no reranker"):
        qs.submit("x", 1, rerank=True)


def test_shutdown_fails_queued_requests():
    pipe = _BlockingPipe()
    srv = QueryServer(pipe, tick_ms=1.0, max_batch=1)
    try:
        srv.submit("a", 1)
        time.sleep(0.1)
        queued = srv.submit("b", 1)
        srv.shutdown(timeout=0.2)
        with pytest.raises(RuntimeError, match="shut down"):
            queued.wait(WAIT)
    finally:
        pipe.release.set()
        srv._thread.join(WAIT)
    assert not srv._thread.is_alive()


class _FakePipe:
    """retrieve(texts, k) fails for k == 13: one poisoned (kind, k) group."""

    reranker = None

    def retrieve(self, texts, k):
        if k == 13:
            raise RuntimeError("boom")
        return [[f"doc{k}"] for _ in texts]


def test_group_isolation():
    probes.REGISTRY.remove("requests_isolated")
    with QueryServer(_FakePipe(), tick_ms=30.0, max_batch=8, serve_restarts=2) as qs:
        good = qs.submit("fine", 1)
        bad = qs.submit("poisoned", 13)
        assert good.wait(WAIT) == ["doc1"]
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(WAIT)
        assert qs.submit("still alive", 2).wait(WAIT) == ["doc2"]
        st = qs.stats()
        assert st["failed"] is False and st["group_failures"] == 1
    assert probes.REGISTRY.labelled("requests_isolated", "outcome") == {"failed": 1.0}


def test_latches_without_supervision():
    qs = QueryServer(_FakePipe(), tick_ms=10.0, max_batch=8)
    try:
        bad = qs.submit("poisoned", 13)
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(WAIT)
        end = time.monotonic() + WAIT
        while not qs.stats()["failed"] and time.monotonic() < end:
            time.sleep(0.01)
        assert qs.stats()["failed"] is True
        with pytest.raises(RuntimeError, match="failed"):
            qs.submit("after latch", 1)
    finally:
        qs.shutdown()


class _CrashingTick(_FakePipe):
    """k == 7 returns no result list, so the tick itself raises (outside
    the group isolation) while resolving its requests: a crashed tick."""

    def retrieve(self, texts, k):
        if k == 7:
            return None
        return super().retrieve(texts, k)


def test_supervised_tick_crash_restarts_then_latches():
    probes.REGISTRY.remove("serve_restarts")
    with QueryServer(_CrashingTick(), tick_ms=5.0, max_batch=1, serve_restarts=1) as qs:
        with pytest.raises(TypeError):
            qs.submit("crash", 7).wait(WAIT)
        assert qs.submit("ok", 1).wait(WAIT) == ["doc1"]
        assert qs.stats()["restarts"] == 1 and not qs.stats()["failed"]
        with pytest.raises(TypeError):
            qs.submit("crash again", 7).wait(WAIT)
        end = time.monotonic() + WAIT
        while not qs.stats()["failed"] and time.monotonic() < end:
            time.sleep(0.01)
        assert qs.stats()["failed"]
    assert probes.REGISTRY.labelled("serve_restarts", "server") == {qs._trace_tag: 1.0}


def test_query_tick_chaos_isolated():
    chaos.configure(rate=1.0, sites="query.tick")
    with QueryServer(_FakePipe(), tick_ms=10.0, max_batch=4, serve_restarts=4) as qs:
        reqs = [qs.submit(f"q{i}", 1) for i in range(3)]
        for r in reqs:
            with pytest.raises(chaos.InjectedFault) as ei:
                r.wait(WAIT)
            assert ei.value.site == "query.tick"
        assert qs.stats()["failed"] is False
    chaos.configure()
    with QueryServer(_FakePipe(), tick_ms=1.0) as qs:
        assert qs._chaos_tick is None and qs.query("x", 3, timeout=WAIT) == ["doc3"]


def test_shutdown_detects_a_leaked_thread():
    pipe = _BlockingPipe()
    qs = QueryServer(pipe, tick_ms=5.0, max_batch=2)
    n0 = len(get_global_error_log().entries)
    try:
        qs.submit("stuck", 1)
        time.sleep(0.1)  # the loop enters the blocked call
        qs.shutdown(timeout=0.3)
        assert qs.stats()["leaked_thread"] == 1
        assert "still alive" in get_global_error_log().entries[n0]["message"]
    finally:
        pipe.release.set()
        qs._thread.join(WAIT)
    assert not qs._thread.is_alive()
