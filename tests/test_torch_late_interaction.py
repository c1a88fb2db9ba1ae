"""The port's late-interaction doc-token bank and MaxSim cascade against
the JAX package (after tests/test_late_interaction.py:100-285, :381 and
the bank case of tests/test_indexing.py).

Both sides get the same numpy weights at the JAX test's width (vocab
4096, hidden 128, 4 layers, 4 heads, ffn 256) in f32, and the port's
embedder gets JAX's projection matrix (``late_proj=``), which its
pipelines take as theirs: the port's own default projection is drawn from
a ``torch.Generator`` and differs.

Tolerances, each with its reason:
* ``_quant_tokens`` on one input: payloads equal, scales within 1e-7;
* token states through the encoder (``doc_token_states``): scales within
  1e-5, payloads within one step (an f32 encode a few ulps apart may round
  a token across a .5 boundary), equal on >= 99% of the entries;
* ``maxsim_scores``: the numpy reference within rtol 2e-5 + 1e-4 (the JAX
  test's bar), JAX's within 1e-5;
* the cascade: ``idx`` equal, knn scores within 1e-5, ``r_scores`` within
  1e-4 (tests/test_torch_rerank_cascade.py's), ``order`` equal wherever
  the scores that decide it differ by more than 1e-4.
"""

import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pathway_tpu.models import transformer as JT
from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.ops import fused_query as JF
from pathway_tpu.ops import late_bank as JL
from pathway_tpu_torch import (
    CrossEncoderModel,
    FusedRAGPipeline,
    QueryServer,
    SentenceEmbedderModel,
)
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.models import transformer as TT
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.ops import fused_query as TF
from pathway_tpu_torch.ops import late_bank as TL
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

TOL = 1e-4
WAIT = 60.0
WIDTH = dict(vocab_size=4096, hidden=128, layers=4, heads=4, intermediate=256)
JCFG = JT.TransformerConfig(**WIDTH, dtype=jnp.float32)
TCFG = TT.TransformerConfig(**WIDTH, dtype=torch.float32)
WORDS = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
                  "iota", "kappa", "mu", "nu", "stream", "index", "query", "tensor"])
PIPE_KW = dict(doc_seq=24, pair_seq=64)


def _np_params(seed):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed), JCFG))


E_NP, R_NP = _np_params(0), _np_params(1)
HEAD = {"w": np.random.default_rng(2).normal(0, 0.5, (128, 1)).astype(np.float32),
        "b": np.zeros((1,), np.float32)}
J_PROJ = np.array(JL.late_projection(128, 32))


def _corpus(n_docs, seed):
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(WORDS, int(rng.integers(4, 21)))) for _ in range(n_docs)]
    queries = [" ".join(rng.choice(WORDS, 5)) for _ in range(10)]
    return docs, queries


@pytest.fixture(scope="module")
def models():
    tok = HashTokenizer(vocab_size=4096)
    emb = SentenceEmbedderModel(TCFG, params=from_jax_params(E_NP), tokenizer=tok,
                                max_length=32, device="cpu", late_proj=torch.from_numpy(J_PROJ))
    rr = CrossEncoderModel(TCFG, params=from_jax_params(R_NP), head=from_jax_params(HEAD),
                           tokenizer=tok, max_length=128, device="cpu")
    yield emb, rr
    emb.close()


def _make_pipe(models, n_docs=256, seed=3, **kw):
    emb, rr = models
    p = FusedRAGPipeline(emb, rr, reserved_space=kw.pop("reserved_space", max(n_docs, 32)),
                         rerank_cascade=True, **PIPE_KW, **kw)
    docs, p.queries = _corpus(n_docs, seed)
    p.docs = docs
    p.add([f"k{i}" for i in range(n_docs)], docs)
    return p


@pytest.fixture(scope="module")
def pipe(models):
    # ingested with late_interaction off: flag-on cases go through the
    # query-time backfill, flag-off cases see a pipeline without a bank
    return _make_pipe(models)


def _late(p, on=True, keep=0):
    p.late_interaction, p.rerank_cascade_survivors = on, keep


# ------------------------------------------------------------- late_bank
@pytest.mark.parametrize("shape", [(2, 5, 8), (3, 7, 32), (1, 1, 4)])
def test_quant_tokens_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    t = rng.normal(size=shape).astype(np.float32)
    t[0, 0] = 0.0  # a padding token: the scale floor, exact zeros
    jq, js = JL._quant_tokens(jnp.asarray(t))
    tq, ts = TL._quant_tokens(torch.from_numpy(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == shape[:2] + (1,)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    assert not tq[0, 0].any()


def test_token_states_match_jax_with_its_projection():
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 4096, (4, 24)).astype(np.int32)
    mask = (np.arange(24)[None, :] < np.array([24, 9, 1, 17])[:, None]).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, E_NP)
    jq, js = JL.doc_token_states(jp, jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(J_PROJ), JCFG)
    tq, ts = TL.doc_token_states(from_jax_params(E_NP), torch.from_numpy(ids),
                                 torch.from_numpy(mask), torch.from_numpy(J_PROJ), TCFG)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    diff = np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert not tq.numpy()[mask == 0].any()  # padding tokens are zeros
    hidden = TT.encode(from_jax_params(E_NP), torch.from_numpy(ids), torch.from_numpy(mask), TCFG)
    got = TL.query_token_states(hidden, torch.from_numpy(mask), torch.from_numpy(J_PROJ))
    jh = JT.encode(jp, jnp.asarray(ids), jnp.asarray(mask), JCFG)
    want = np.asarray(JL.query_token_states(jh, jnp.asarray(mask), jnp.asarray(J_PROJ)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    live = np.linalg.norm(got.numpy(), axis=-1)[mask == 1]
    np.testing.assert_allclose(live, 1.0, atol=1e-5)


def test_maxsim_scores_matches_numpy_reference_and_jax():
    """``sum over query tokens of the max dot over each doc's live
    tokens``; a zero-length doc scores a finite, very bad value."""
    rng = np.random.default_rng(0)
    qb, s, k, t, dc = 2, 5, 3, 7, 8
    q_tok = rng.normal(size=(qb, s, dc)).astype(np.float32)
    q_mask = np.ones((qb, s), dtype=np.int32)
    q_mask[0, 3:] = 0
    bank = rng.normal(size=(qb, k, t, dc)).astype(np.float32)
    scale = np.abs(rng.normal(size=(qb, k, t, 1))).astype(np.float32) + 0.1
    bank_q = np.clip(np.round(bank / scale), -127, 127).astype(np.int8)
    d_lens = np.array([[7, 3, 0], [1, 7, 2]], dtype=np.int32)
    args = (q_tok, q_mask, bank_q, scale, d_lens)
    got = TL.maxsim_scores(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, np.asarray(JL.maxsim_scores(*(jnp.asarray(a) for a in args))),
                               rtol=0, atol=1e-5)
    d = bank_q.astype(np.float32) * scale
    for b in range(qb):
        for j in range(k):
            n = d_lens[b, j]
            if n == 0:
                assert np.isfinite(got[b, j]) and got[b, j] < -1e6
                continue
            want = sum(float(np.max(d[b, j, :n] @ q_tok[b, i]))
                       for i in range(s) if q_mask[b, i])
            np.testing.assert_allclose(got[b, j], want, rtol=2e-5, atol=1e-4)


def test_flops_and_row_bytes_match_jax():
    for args in ((16, 24, 32, 7), (63, 96, 32, 2048), (1, 1, 1, 1)):
        assert TL.maxsim_flops(*args) == JL.maxsim_flops(*args)
        assert TL.projection_flops(*args) == JL.projection_flops(*args)
    assert TL.bank_row_bytes(96, 32) == JL.bank_row_bytes(96, 32) == 3456


def test_late_projection_is_deterministic():
    a, b = TL.late_projection(64, 16), TL.late_projection(64, 16)
    assert torch.equal(a, b) and a.shape == (64, 16) and a.dtype == torch.float32
    assert not torch.equal(a, TL.late_projection(64, 16, seed=1))
    assert abs(float(a.std()) * 8.0 - 1.0) < 0.2  # scale 1/sqrt(hidden)


# ------------------------------------------------------------ the cascade
def _order_equal_up_to_ties(got, want, r_scores, tol=TOL):
    for g_row, w_row, s_row in zip(got, want, r_scores):
        for g, w in zip(g_row, w_row):
            if g != w:
                assert abs(s_row[g] - s_row[w]) <= tol, (g, w)


@pytest.mark.parametrize("keep,seed_w,k", [(8, 0.25, 16), (5, 0.0, 8), (30, 1.0, 32)])
def test_maxsim_cascade_matches_jax(pipe, keep, seed_w, k, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_LATE_INTERACTION", "1")
    monkeypatch.setenv("PATHWAY_TPU_RERANK_CASCADE", "1")
    monkeypatch.delenv("PATHWAY_TPU_LATE_DIM", raising=False)
    tok = JTok(vocab_size=4096)
    jemb = JEmbed(JCFG, params=jax.tree.map(jnp.asarray, E_NP), tokenizer=tok, max_length=32)
    jp = JF.FusedRAGPipeline(jemb, JCross(JCFG, params=jax.tree.map(jnp.asarray, R_NP),
                                          head=jax.tree.map(jnp.asarray, HEAD), tokenizer=tok,
                                          max_length=128),
                             reserved_space=256, **PIPE_KW)
    try:
        jp.add([f"k{i}" for i in range(len(pipe.docs))], pipe.docs)
        texts = pipe.queries[:6]
        arrays, k_eff, pair_seq = jp._rerank_args(texts, k)
        args = jp._maxsim_args(arrays)
        assert np.array_equal(np.asarray(jp._late_proj), J_PROJ)
        want = [np.asarray(a) for a in JF._fused_retrieve_maxsim_cascade(
            *args, jp.embedder.cfg, jp.reranker.cfg, k_eff, jp.metric, pair_seq, keep,
            seed_w)]
    finally:
        jemb.close()
    _late(pipe, True, keep)
    pipe.rerank_seed_weight = seed_w
    try:
        got = [t.numpy() for t in pipe.retrieve_rerank_batch_device(texts, k)]
    finally:
        _late(pipe, False)
        pipe.rerank_seed_weight = 0.25
    n = len(texts)
    scores, idx, r_scores, order = (a[:n] for a in got)
    w_scores, w_idx, w_r, w_order = (a[:n] for a in want)
    assert np.array_equal(idx, w_idx)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_scores, w_r, rtol=0, atol=TOL)
    _order_equal_up_to_ties(order, w_order, w_r)
    for row in order:
        assert sorted(row.tolist()) == list(range(k))


def test_late_interaction_off_is_the_encoder_cascade_bitwise(models):
    """Flag off with the cascade on: exactly the encoder cascade's
    outputs, and the pipeline never allocates a bank."""
    pipe = _make_pipe(models, n_docs=64, seed=9)
    assert pipe._bank_q is None and pipe.late_interaction is False  # the JAX default
    text, k = pipe.queries[0], 16
    got = pipe.retrieve_rerank_device(text, k)
    depth, keep, seed_w = pipe._cascade_plan(k)
    ids, mask, q_max = pipe._tokenize_queries(
        [text], max_length=min(pipe.embedder.max_length, pipe._rerank_q_budget))
    e, r = pipe.embedder, pipe.reranker
    want = TF._retrieve_rerank_cascade(
        e.params, ids, mask, pipe.index._corpus, pipe.index._valid, pipe._doc_tokens,
        pipe._doc_lens, r.params, r.head, e.cfg, r.cfg, k, pipe.metric,
        pipe._pair_bucket(q_max), depth, keep, seed_w)
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])
    assert pipe._bank_q is None
    assert TP.hbm_owner_bytes(pipe.hbm_owner) == {}


def test_maxsim_overlap_top8(pipe):
    """The MaxSim cheap stage keeps >= 0.9 mean top-8 overlap with the
    full rerank at 30 of 32 survivors (the JAX test's operating point)."""
    pipe.rerank_cascade = False
    try:
        full = [[key for key, _ in pipe.retrieve_rerank(q, k=32)[:8]] for q in pipe.queries]
    finally:
        pipe.rerank_cascade = True
    _late(pipe, True, 30)
    try:
        overlaps = [len({key for key, _ in pipe.retrieve_rerank(q, k=32)[:8]} & set(w)) / 8.0
                    for q, w in zip(pipe.queries, full)]
    finally:
        _late(pipe, False)
    assert sum(overlaps) / len(overlaps) >= 0.9, overlaps


def test_maxsim_flops_collapse_and_attribution(pipe):
    q_seq = min(pipe.embedder.max_length, pipe._rerank_q_budget)
    per_pair_maxsim = TL.maxsim_flops(q_seq, pipe.doc_seq, 32, 1)
    per_pair_cheap = TF._encoder_flops(pipe.reranker.cfg, pipe.pair_seq, 3, 1)
    assert per_pair_cheap >= 5.0 * per_pair_maxsim
    _late(pipe, True, 30)
    try:
        before = TP.cascade_stats()
        d0 = TP.dispatch_counts()
        pipe.retrieve_rerank(pipe.queries[0], k=32)
        after = TP.cascade_stats()
        d1 = TP.dispatch_counts()
    finally:
        _late(pipe, False)
    d = {s: after["pairs"].get(s, 0) - before["pairs"].get(s, 0)
         for s in ("maxsim", "full", "cheap")}
    assert d == {"maxsim": 32, "full": 30, "cheap": 0}
    gf = {s: after["gflops"].get(s, 0) - before["gflops"].get(s, 0) for s in ("maxsim", "full")}
    assert 0 < gf["maxsim"] < gf["full"] / 5.0
    assert d1.get("fused_rerank_maxsim", 0) - d0.get("fused_rerank_maxsim", 0) == 1


def test_maxsim_batched_equals_per_query_loop(pipe):
    _late(pipe, True, 8)
    try:
        texts = pipe.queries[:3]
        batched = pipe.retrieve_rerank_batch(texts, k=16)
        looped = [pipe.retrieve_rerank(t, k=16) for t in texts]
    finally:
        _late(pipe, False)
    for b, lo in zip(batched, looped):
        assert [key for key, _ in b] == [key for key, _ in lo]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in lo], rtol=0, atol=1e-4)


# ------------------------------------------------- bank lifecycle / HBM
def test_bank_backfills_after_flag_flip(models, monkeypatch):
    p = _make_pipe(models, n_docs=48, seed=11)
    assert p._bank_q is None
    _late(p, True, 8)
    out = p.retrieve_rerank(p.queries[0], k=16)
    assert p._bank_q is not None and p._bank_valid[: p.index.n].all()
    keys = [key for key, _ in out]
    assert len(keys) == len(set(keys)) == 16
    owner = TP.hbm_owner_bytes(p.hbm_owner)["late_bank"]
    assert owner == 48 * TL.bank_row_bytes(24, 32)
    # off again: new rows are marked stale, the next MaxSim query backfills
    _late(p, False)
    docs, _ = _corpus(20, 12)
    p.add([f"n{i}" for i in range(20)], docs)
    assert not p._bank_valid[48:68].any()
    assert TP.hbm_owner_bytes(p.hbm_owner)["late_bank"] == owner
    built = TP.dispatch_counts().get("late_bank_build", 0)
    _late(p, True, 8)
    p.retrieve_rerank(p.queries[1], k=16)
    assert TP.dispatch_counts().get("late_bank_build", 0) == built + 1  # one batch
    assert p._bank_valid[:68].all()
    assert TP.hbm_owner_bytes(p.hbm_owner)["late_bank"] == 68 * TL.bank_row_bytes(24, 32)

    def boom(*a, **k):  # noqa: ARG001
        raise AssertionError("backfill re-ran on a fully valid bank")

    monkeypatch.setattr(p, "_late_bank_rows", boom)
    p.retrieve_rerank(p.queries[2], k=16)


def test_retraction_lowers_the_gauge_and_moved_rows_stay_aligned(models):
    """Swap-with-last removal moves each bank row with its document: every
    surviving slot's row equals a fresh encode of its own text, the gauge
    falls by the removed rows' bytes exactly, and a query for a moved
    document finds it; a re-add brings rows back."""
    # an earlier test's pipeline sits in a reference cycle (monkeypatch's
    # undo binds a method onto it): collect it now, so that its ledger drop
    # cannot land between the gauge reads below
    gc.collect()
    p = _make_pipe(models, n_docs=40, seed=7, late_interaction=True)
    row = TL.bank_row_bytes(24, 32)
    full = TP.hbm_stats()["current_bytes"]["late_bank"]
    assert TP.hbm_owner_bytes(p.hbm_owner) == {"late_bank": 40 * row}
    texts = dict(zip([f"k{i}" for i in range(40)], p.docs))
    gone = ["k3", "k17", "k0", "k9", "k20"]
    p.remove(gone)
    assert TP.hbm_stats()["current_bytes"]["late_bank"] == full - 5 * row
    assert int(p._bank_valid.sum()) == 35 and not p._bank_valid[35:].any()
    for key, text in texts.items():
        slot = p.index._slot_of.get(key)
        if key in gone:
            assert slot is None
            continue
        ids, lens = p._doc_token_rows([text])
        bq, bs = p._late_bank_rows(ids, lens)
        assert torch.equal(p._bank_q[slot], bq[0]) and torch.equal(p._bank_scale[slot], bs[0])
        assert int(p._doc_lens[slot]) == int(lens[0])
    moved = p.index._keys[3]  # the last document took slot 3
    p.rerank_cascade_survivors = 8
    hits = p.retrieve_rerank(texts[moved], k=8)
    keys = [key for key, _ in hits]
    assert moved in keys and not set(keys) & set(gone)
    out = p.retrieve_rerank(p.queries[0], k=35)
    assert len({key for key, _ in out}) == 35 and not {key for key, _ in out} & set(gone)
    p.add(gone, [texts[g] for g in gone])
    assert p._bank_valid[: p.index.n].all()
    assert TP.hbm_stats()["current_bytes"]["late_bank"] == full


def test_bank_grows_with_the_index(models):
    p = _make_pipe(models, n_docs=20, seed=13, late_interaction=True, reserved_space=16)
    assert p._bank_q.shape[0] == p.index.capacity == p._doc_tokens.shape[0] == 32
    docs, _ = _corpus(30, 14)
    p.add([f"g{i}" for i in range(30)], docs)
    assert p._bank_q.shape[0] == p.index.capacity == 64 == len(p._bank_valid)
    assert p._bank_valid[:50].all() and not p._bank_valid[50:].any()


def test_late_dim_freezes_at_first_alloc(models):
    # the embedder's matrix is 32 wide: at 16 it draws the port's own
    p = _make_pipe(models, n_docs=32, seed=5, late_interaction=True, late_dim=16)
    assert p._bank_q.shape[-1] == 16 and p._late_proj.shape == (128, 16)
    assert torch.equal(p._late_proj, TL.late_projection(128, 16))
    p.late_dim = 64
    p.retrieve_rerank(p.queries[0], k=8)
    assert p._bank_q.shape[-1] == 16 and p._late_proj.shape == (128, 16)
    assert p._late_dim == 16


def test_pipeline_bank_rows_use_the_embedders_projection(models):
    """One source for the projection: the pipeline's bank rows equal the
    embedder's ``token_bank_submit`` rows at the bank's width."""
    emb, _ = models
    p = _make_pipe(models, n_docs=8, seed=23, late_interaction=True)
    assert p._late_proj is emb.late_projection_matrix(32)
    assert np.array_equal(p._late_proj.numpy(), J_PROJ)
    ids, lens = p._doc_token_rows(p.docs[:3])
    bq, bs = p._late_bank_rows(ids, lens)
    slots = [p.index._slot_of[f"k{i}"] for i in range(3)]
    assert torch.equal(p._bank_q[slots], bq) and torch.equal(p._bank_scale[slots], bs)


def test_two_pipelines_keep_their_own_bank_bytes(models):
    TP.reset_hbm_stats()
    a = _make_pipe(models, n_docs=16, seed=21, late_interaction=True)
    b = _make_pipe(models, n_docs=24, seed=22, late_interaction=True)
    row = TL.bank_row_bytes(24, 32)
    assert TP.hbm_stats()["current_bytes"]["late_bank"] == 40 * row
    assert TP.hbm_owner_bytes(b.hbm_owner) == {"late_bank": 24 * row}
    a.close()
    assert a._bank_q is None and TP.hbm_owner_bytes(a.hbm_owner) == {}
    assert TP.hbm_stats()["current_bytes"]["late_bank"] == 24 * row
    b.close()
    assert "late_bank" not in TP.hbm_stats()["current_bytes"]
    # a closed pipeline keeps its corpus: a late query rebuilds the bank
    a.rerank_cascade_survivors = 8
    a.retrieve_rerank(a.queries[0], k=8)
    assert a._bank_valid[: a.index.n].all()
    assert TP.hbm_stats()["current_bytes"]["late_bank"] == 16 * row
    a.close()


# ---------------------------------------------------- the token-level path
def test_token_bank_submit_resolve_pipelined_and_serial():
    """The embedder's token path: int8 payloads and f32 scales shaped (n,
    S, dc) / (n, S, 1), equal between the pipelined (fused and split h2d)
    and serial paths, and handles resolve mixed."""
    import dataclasses

    cfg = dataclasses.replace(TCFG, layers=1, hidden=16, heads=2, intermediate=32,
                              vocab_size=500, max_position=32)
    texts = ["aa bb cc", "dd", None]
    outs = []
    for kw in (dict(), dict(fused_h2d=False), dict(pipeline=False)):
        model = SentenceEmbedderModel(cfg, max_length=16, device="cpu",
                                      tokenizer=HashTokenizer(vocab_size=500), **kw)
        emb = SentenceTransformerEmbedder(model)
        try:
            h = emb.embed_tokens_submit(texts, dc=8)
            h2 = model.token_bank_submit(["ee ff"])
            (q, s), (q2, s2) = emb.embed_tokens_resolve([h, h2], timeout=WAIT)
            assert q.shape == (3, 16, 8) and q.dtype == np.int8
            assert s.shape == (3, 16, 1) and s.dtype == np.float32
            assert q2.shape == (1, 16, 32)  # the default width, LATE_DIM
            outs.append((q, s, q2, s2))
        finally:
            model.close()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert np.array_equal(a, b)
    # a serial handle beside a pipelined one, one resolve
    model = SentenceEmbedderModel(cfg, max_length=16, device="cpu",
                                  tokenizer=HashTokenizer(vocab_size=500))
    try:
        h = model.token_bank_submit(["aa bb cc"], dc=8)
        model.pipeline = False
        serial = model.token_bank_submit(["aa bb cc"], dc=8)
        (qa, sa), (qb, sb) = model.token_bank_resolve([serial, h], timeout=WAIT)
        assert np.array_equal(qa, qb) and np.array_equal(sa, sb)
        assert np.array_equal(qa, outs[0][0][:1])
    finally:
        model.close()


def test_token_bank_matches_jax_with_its_projection(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_PIPELINE", "0")
    texts = ["alpha beta gamma", "delta", "stream index query tensor theta"]
    tok = HashTokenizer(vocab_size=4096)
    tm = SentenceEmbedderModel(TCFG, params=from_jax_params(E_NP), tokenizer=tok,
                               max_length=32, device="cpu", late_proj=torch.from_numpy(J_PROJ))
    jm = JEmbed(JCFG, params=jax.tree.map(jnp.asarray, E_NP),
                tokenizer=JTok(vocab_size=4096), max_length=32)
    try:
        ((tq, ts),) = tm.token_bank_resolve([tm.token_bank_submit(texts)], timeout=WAIT)
        ((jq, js),) = jm.token_bank_resolve([jm.token_bank_submit(texts, dc=32)])
    finally:
        tm.close()
        jm.close()
    assert tq.shape == np.asarray(jq).shape
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
    diff = np.abs(tq.astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


# --------------------------------------------------------- the query server
def test_query_server_reaches_the_maxsim_cascade(pipe):
    _late(pipe, True, 8)
    try:
        want = pipe.retrieve_rerank_batch(pipe.queries[:4], 16)
        d0 = TP.dispatch_counts().get("fused_rerank_maxsim", 0)
        with QueryServer(pipe, tick_ms=20.0) as srv:
            reqs = [srv.submit(q, 16, rerank=True) for q in pipe.queries[:4]]
            got = [r.wait(WAIT) for r in reqs]
        assert TP.dispatch_counts().get("fused_rerank_maxsim", 0) > d0
    finally:
        _late(pipe, False)
    for g, w in zip(got, want):
        assert [key for key, _ in g] == [key for key, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=1e-4)
