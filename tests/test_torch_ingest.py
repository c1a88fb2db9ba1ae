"""The port's ingest defaults on the CPU: the threaded ingest pipeline of
``SentenceEmbedderModel``, the tokenizer encode memo and the embedding
dedup of ``SentenceTransformerEmbedder``, case by case after the JAX
package's tests (tests/test_embedder_pipeline.py, the memo and dedup cases
of tests/test_prefix_cache.py), each also held against the JAX
``SentenceEmbedderModel`` on the same weights.

Tolerances, each with its reason:
* port against port (pipelined, fused copy off, serial, memo, dedup):
  byte-equal — the same bucket shapes run the same products;
* port against JAX: cosine >= 0.9999 (f32 encoder; summation order and the
  float16 device-to-host cast on both sides, as tests/test_torch_rag.py).

The ``embed.h2d`` chaos site (after tests/test_chaos.py): a faulted
stage-and-dispatch is retried within ``serve_retries`` when
``serve_restarts > 0``, so every batch that resolves is byte-equal to
chaos off, and a batch whose budget ran out raises its ``InjectedFault``
at resolve; none is dropped.

Every wait is bounded (``WAIT`` seconds), so a lost batch fails its test
instead of hanging the run.
"""

import numpy as np
import pytest

from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu_torch.engine import chaos
from pathway_tpu_torch.models.embedder import (
    SentenceEmbedderModel,
    _IngestPipeline,
    _PendingEmbed,
)
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder
from tests.torch_parity import configs, np_encoder_params, to_jax

WAIT = 60.0
VOCAB, MAX_LEN = 1000, 16
NPP = np_encoder_params(seed=21)

TEXTS = [
    ["the quick brown fox", "jumps over the lazy dog"],
    ["streaming rag ingest", "tokenize h2d embed", "bounded queues"],
    ["a single row batch"],
    ["pipeline depth two", "ping pong buffers", "donated inputs", "drain",
     "Ünïcode café rows re-tokenize in Python"],
]


def _model(**kw) -> SentenceEmbedderModel:
    _, tcfg = configs("float32")
    tok_kw = {k: kw.pop(k) for k in ("native", "memo") if k in kw}
    return SentenceEmbedderModel(
        tcfg, params=from_jax_params(NPP),
        tokenizer=HashTokenizer(vocab_size=VOCAB, max_length=MAX_LEN, **tok_kw),
        max_length=MAX_LEN, device="cpu", **kw)


def _serial(**kw) -> SentenceEmbedderModel:
    return _model(pipeline=False, native=False, memo=False, **kw)


@pytest.fixture(scope="module")
def jax_vectors():
    """JAX SentenceEmbedderModel's vectors of every TEXTS batch (and the
    16 small batches of the backpressure case), on the same weights."""
    jcfg, _ = configs("float32")
    jm = JEmbed(jcfg, params=to_jax(NPP),
                tokenizer=JTok(vocab_size=VOCAB, max_length=MAX_LEN),
                max_length=MAX_LEN)
    try:
        return {tuple(t): jm.embed_batch(t) for t in TEXTS + _SMALL_BATCHES}
    finally:
        jm.close()


_SMALL_BATCHES = [[f"doc {i} alpha", f"doc {i} beta"] for i in range(16)]


def _near_jax(got, texts, jax_vectors):
    want = jax_vectors[tuple(texts)]
    assert got.shape == want.shape and got.dtype == np.float32
    cos = np.sum(got * want, axis=1)
    assert cos.min() >= 0.9999, cos.min()


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ pipeline
def test_pipeline_matches_serial_bytes(jax_vectors):
    serial, piped = _serial(), _model()
    try:
        want = [serial.embed_batch(t) for t in TEXTS]
        assert serial._pipeline is None  # pipeline=False builds no worker
        got = [piped.embed_resolve([piped.embed_submit(t)], WAIT)[0] for t in TEXTS]
        assert piped._pipeline is not None
        _equal(got, want)
        for g, t in zip(got, TEXTS):
            _near_jax(g, t, jax_vectors)
    finally:
        piped.close()


def test_fused_h2d_on_and_off_byte_equal(jax_vectors):
    """``fused_h2d`` stacks ids and mask into one (2, B, S) buffer and one
    copy; off, two buffers and two copies. The bytes out are the same."""
    fused, split = _model(), _model(fused_h2d=False)
    try:
        a = [fused.embed_resolve([fused.embed_submit(t)], WAIT)[0] for t in TEXTS]
        b = [split.embed_resolve([split.embed_submit(t)], WAIT)[0] for t in TEXTS]
        _equal(a, b)
        for g, t in zip(a, TEXTS):
            _near_jax(g, t, jax_vectors)
    finally:
        fused.close()
        split.close()


def test_interleaved_submit_resolve(jax_vectors):
    m, serial = _model(), _serial()
    try:
        want = [serial.embed_batch(t) for t in TEXTS[:3]]
        (r0,) = m.embed_resolve([m.embed_submit(TEXTS[0])], WAIT)
        h1, h2 = m.embed_submit(TEXTS[1]), m.embed_submit(TEXTS[2])
        r1, r2 = m.embed_resolve([h1, h2], WAIT)
        _equal([r0, r1, r2], want)
        _near_jax(r1, TEXTS[1], jax_vectors)
    finally:
        m.close()


def test_out_of_order_resolve(jax_vectors):
    m, serial = _model(), _serial()
    try:
        want = [serial.embed_batch(t) for t in TEXTS]
        handles = [m.embed_submit(t) for t in TEXTS]
        assert all(isinstance(h, _PendingEmbed) for h in handles)
        got = m.embed_resolve(list(reversed(handles)), WAIT)
        _equal(got, list(reversed(want)))
        _near_jax(got[0], TEXTS[-1], jax_vectors)
    finally:
        m.close()


def test_mixed_serial_and_pipelined_handles(jax_vectors):
    """embed_resolve takes handles of both paths in one drain, in any
    order; ``pipeline`` is read at each submit."""
    m, serial = _model(), _serial()
    try:
        want = [serial.embed_batch(t) for t in TEXTS[:2]]
        m.pipeline = False
        h_serial = m.embed_submit(TEXTS[0])
        m.pipeline = True
        h_piped = m.embed_submit(TEXTS[1])
        assert isinstance(h_piped, _PendingEmbed) and not isinstance(h_serial, _PendingEmbed)
        got = m.embed_resolve([h_piped, h_serial], WAIT)
        _equal(got, [want[1], want[0]])
        _near_jax(got[1], TEXTS[0], jax_vectors)
    finally:
        m.close()


def test_backpressure_tiny_queues_no_deadlock(jax_vectors):
    """Queue bound 1, depth 1: submits block instead of growing the
    queues, and 16 batches in flight resolve to the serial bytes."""
    want = [_serial().embed_batch(t) for t in _SMALL_BATCHES]
    m = _model(pipeline_depth=1, pipeline_queue=1)
    try:
        handles = [m.embed_submit(t) for t in _SMALL_BATCHES]
        assert m._pipeline._dispatch._queue.maxsize == 1
        assert m._pipeline._tokenize._queue.maxsize == 1
        got = m.embed_resolve(handles, WAIT)
        _equal(got, want)
        for g, t in zip(got, _SMALL_BATCHES):
            _near_jax(g, t, jax_vectors)
    finally:
        m.close()


def test_empty_batch_short_circuits():
    m = _model()
    try:
        assert m.embed_batch([]).shape == (0, 32)
        assert m._pipeline is None  # nothing was submitted
    finally:
        m.close()


def test_tokenizer_error_surfaces_at_resolve(jax_vectors):
    """A stage failure does not kill the worker; it is raised at resolve."""
    m = _model()
    try:
        bad = m.embed_submit([object()])  # not a str: the tokenizer raises
        good = m.embed_submit(TEXTS[0])
        with pytest.raises(TypeError):
            m.embed_resolve([bad], WAIT)
        (r,) = m.embed_resolve([good], WAIT)  # the pipeline is still alive
        _near_jax(r, TEXTS[0], jax_vectors)
    finally:
        m.close()


def test_pipeline_records_every_stage():
    from pathway_tpu_torch.engine import probes

    probes.reset_stage_seconds()
    m = _model()
    try:
        m.embed_resolve([m.embed_submit(t) for t in TEXTS], WAIT)
    finally:
        m.close()
    items = probes.stage_items()
    assert items["tokenize"] == items["h2d"] == items["dispatch"] == len(TEXTS)
    assert items["drain"] == 1


def test_ingest_defaults_are_the_jax_flag_defaults():
    m = _model()
    assert (m.pipeline, m.pipeline_depth, m.pipeline_queue, m.fused_h2d) == (True, 2, 8, True)
    tok = SentenceEmbedderModel(configs("float32")[1], device="cpu").tokenizer
    assert tok.native is True and tok._memo is not None
    emb = SentenceTransformerEmbedder(m)
    assert emb.dedup is True


# ---------------------------------------------------------------- memo path
@pytest.mark.parametrize("native", [True, False])
def test_memo_embeddings_byte_equal_and_hit_counts(native, jax_vectors):
    """The memo serves repeated texts without changing a byte; after a
    first pass every row is a hit (one entry per distinct text)."""
    cold = _model(native=native, memo=False)
    warm = _model(native=native)
    try:
        texts = TEXTS[3] + TEXTS[3][:2]
        a = cold.embed_resolve([cold.embed_submit(texts)], WAIT)[0]
        b1 = warm.embed_resolve([warm.embed_submit(texts)], WAIT)[0]
        assert len(warm.tokenizer._memo) == len(set(texts))
        b2 = warm.embed_resolve([warm.embed_submit(texts)], WAIT)[0]
        assert len(warm.tokenizer._memo) == len(set(texts))
        _equal([a, a], [b1, b2])
        _near_jax(b2[: len(TEXTS[3])], TEXTS[3], jax_vectors)
    finally:
        cold.close()
        warm.close()


# ---------------------------------------------------------------- dedup seam
def test_embed_dedup_parity_with_jax_hit_counts(monkeypatch, jax_vectors):
    """tests/test_prefix_cache.py's dedup case on the port's seam: the
    same hits and misses as the JAX embedder, vectors byte-equal to the
    model's own, and an all-hit submit opens no device handle."""
    import pathway_tpu.models.embedder  # noqa: F401 - JAX embedder for the seam
    from pathway_tpu.xpacks.llm import embedders as JE

    m = _model()
    try:
        texts = ["aa bb", "cc dd", "aa bb", "ee"]
        ref = list(m.embed_batch(texts))
        emb = SentenceTransformerEmbedder(m)
        got1 = emb(texts)
        assert emb.dedup_stats == {"hits": 1, "misses": 3}
        got2 = emb(texts)
        assert emb.dedup_stats["hits"] == 5
        handle = emb.submit_batch(["aa bb", "cc dd"])
        assert handle[0] == "dedup" and handle[1] is None
        (got3,) = emb.resolve_batch([handle], WAIT)
        _equal(got1, ref)
        _equal(got2, ref)
        _equal(got3, ref[:2])

        # JAX's embedder counts the same hits and misses
        monkeypatch.setenv("PATHWAY_TPU_EMBED_DEDUP", "1")
        jcfg, _ = configs("float32")
        jm = JEmbed(jcfg, params=to_jax(NPP),
                    tokenizer=JTok(vocab_size=VOCAB, max_length=MAX_LEN),
                    max_length=MAX_LEN)
        try:
            jemb = JE.SentenceTransformerEmbedder(jm)
            jgot = jemb.__wrapped__(texts)
            assert jemb.dedup_stats == {"hits": 1, "misses": 3}
            jemb.__wrapped__(texts)
            jh = jemb.submit_batch(["aa bb", "cc dd"])
            jemb.resolve_batch([jh])
            assert jemb.dedup_stats == emb.dedup_stats
        finally:
            jm.close()
        cos = np.sum(np.stack(got1) * np.stack(jgot), axis=1)
        assert cos.min() >= 0.9999

        off = SentenceTransformerEmbedder(m, dedup=False)
        raw = off.submit_batch(texts)
        assert raw[0] == "raw"
        (got_off,) = off.resolve_batch([raw], WAIT)
        assert off.dedup_stats == {"hits": 0, "misses": 0}
        _equal(got_off, ref)
    finally:
        m.close()


def test_dedup_two_phase_mixed_batches_and_lru_bound(monkeypatch):
    """Several submits before one resolve: partial hits, all-hit and raw
    batches come back in order; the LRU keeps at most ``DEDUP_MAX``
    texts (8,192, as in JAX; cut to 4 here to reach the bound)."""
    from pathway_tpu.xpacks.llm import embedders as JE
    from pathway_tpu_torch.xpacks.llm import embedders as TE

    assert TE.DEDUP_MAX == JE._DEDUP_MAX == 8192
    monkeypatch.setattr(TE, "DEDUP_MAX", 4)
    m = _model()
    try:
        emb = SentenceTransformerEmbedder(m)
        first = emb.submit_batch(["a", "b", "c"])
        again = emb.submit_batch(["a", "b", "c", "d"])  # not yet filled: misses
        out = emb.resolve_batch([first, again], WAIT)
        assert emb.dedup_stats == {"hits": 0, "misses": 7}
        assert len(emb._dedup) == 4
        hit = emb.submit_batch(["d", "c"])
        assert hit[1] is None
        (h,) = emb.resolve_batch([hit], WAIT)
        want = m.embed_batch(["a", "b", "c", "d"])
        _equal(out[0], want[:3])
        _equal(out[1], want)
        _equal(h, [want[3], want[2]])
        assert emb(["z", None]) and emb.get_embedding_dimension() == 32
    finally:
        m.close()


def test_seam_model_resolution(tmp_path):
    from pathway_tpu_torch.xpacks.llm import CrossEncoderReranker

    emb = SentenceTransformerEmbedder("minilm-l6", device="cpu", pipeline=False)
    assert emb.model.cfg.layers == 6 and emb.get_embedding_dimension() == 384
    with pytest.raises(TypeError):
        SentenceTransformerEmbedder(3.5)
    rr = CrossEncoderReranker(custom_kwargs=dict(
        cfg=configs("float32")[1], tokenizer=HashTokenizer(vocab_size=VOCAB), device="cpu"))
    scores = rr(["doc one", None], ["query", "q"])
    assert len(scores) == 2 and all(isinstance(s, float) for s in scores)
    (two,) = rr.resolve_batch([rr.submit_batch(["doc one", None], ["query", "q"])])
    assert two == scores


# ------------------------------------------------------------- concurrency
def test_shared_tokenizer_and_pipeline_under_thread_stress():
    """More threads than cores share one model (its memo and its pipeline)
    with a short switch interval: every thread's vectors equal the serial
    path's bytes and the memo holds one entry per distinct text, which a
    lost memo update or a crossed batch would break. Joins are bounded."""
    import os
    import sys
    import threading

    batches = [[f"doc {i % 5} shared", f"doc {i} own", "common text"] for i in range(24)]
    serial = _serial()
    want = [serial.embed_batch(b) for b in batches]
    m = _model(pipeline_depth=1, pipeline_queue=2)
    n_threads = max(8, 2 * (os.cpu_count() or 1))
    got: dict = {}
    errors: list = []

    def work(k):
        try:
            for j in range(k, len(batches), n_threads):
                got[j] = m.embed_resolve([m.embed_submit(batches[j])], WAIT)[0]
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        m.close()
    assert not errors, errors
    assert sorted(got) == list(range(len(batches)))
    _equal([got[j] for j in range(len(batches))], want)
    assert len(m.tokenizer._memo) == len({t for b in batches for t in b})


# ------------------------------------------------------------ embed.h2d chaos
def test_embed_h2d_chaos_provenance_and_retry():
    """The h2d site faults with provenance; the bounded retry re-attempts
    the stage (the site counts both tries) before the error surfaces."""
    pipe = _IngestPipeline.__new__(_IngestPipeline)
    pipe._chaos_h2d = chaos.ChaosSite("embed.h2d", 1.0, 0)
    pipe._retries = 1
    handle = _PendingEmbed()
    pipe._dispatch_one((None, None, 1, handle))
    assert handle._event.is_set()
    assert isinstance(handle._error, chaos.InjectedFault)
    assert handle._error.site == "embed.h2d" and handle._error.seq == 2


def _surviving(seed: int, rate: float, retries: int, n_batches: int):
    """Which batches resolve, and the site's operation count, replaying
    its schedule: the dispatch worker is one thread, so its operations run
    in submit order."""
    site, out = chaos.ChaosSite("embed.h2d", rate, seed), []
    for _ in range(n_batches):
        ok = False
        for _ in range(retries + 1):
            try:
                site.maybe_fail()
                ok = True
                break
            except chaos.InjectedFault:
                pass
        out.append(ok)
    return out, site._seq


@pytest.mark.parametrize("seed,serve_restarts,serve_retries", [
    (0, 1, 3),   # faults, every batch recovered by its retries
    (0, 0, 3),   # retries off (the default restarts): first faults surface
    (1, 1, 3),   # some batches spend their whole budget
])
def test_embed_h2d_chaos_batches_byte_equal_or_raise(seed, serve_restarts, serve_retries):
    batches = TEXTS + _SMALL_BATCHES
    want = [_serial().embed_batch(t) for t in batches]
    retries = serve_retries if serve_restarts > 0 else 0
    ok, ops = _surviving(seed, 0.4, retries, len(batches))
    m = _model(serve_restarts=serve_restarts, serve_retries=serve_retries)
    assert m.h2d_retries == retries
    # the pipeline, and with it the site, is built at the first submit
    chaos.configure(rate=0.4, seed=seed, sites="embed.h2d")
    try:
        handles = [m.embed_submit(t) for t in batches]
        chaos.configure()
        for h, w, good in zip(handles, want, ok):
            if good:
                np.testing.assert_array_equal(m.embed_resolve([h], WAIT)[0], w)
            else:
                with pytest.raises(chaos.InjectedFault) as ei:
                    m.embed_resolve([h], WAIT)
                assert ei.value.site == "embed.h2d"
        assert m._pipeline._chaos_h2d._seq == ops
    finally:
        chaos.configure()
        m.close()
    if serve_restarts and seed == 0:
        assert all(ok) and ops > len(batches)  # every fault was retried away
    else:
        assert not all(ok)


def test_embed_h2d_site_off_by_default():
    m = _model()
    try:
        m.embed_resolve([m.embed_submit(TEXTS[0])], WAIT)
        assert m._pipeline._chaos_h2d is None and m._pipeline._retries == 0
    finally:
        m.close()
