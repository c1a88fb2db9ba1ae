"""The port's cascaded rerank against the JAX package (after
tests/test_rerank_cascade.py).

* Cascade off: the pipeline's rerank is bitwise the plain
  ``_retrieve_rerank`` (pair buckets on and off).
* The port's ``_retrieve_rerank_cascade`` against JAX's
  ``_fused_retrieve_rerank_cascade`` on the same converted weights and
  corpus (f32): ``idx`` equal, ``order`` equal wherever the adjacent
  scores that decide it differ by more than 1e-4, ``r_scores`` within 1e-4
  (the cross-encoder tolerance of tests/test_torch_rag.py).
* The port alone: top-8 overlap with the full rerank >= 0.9 at JAX's
  operating point on JAX's 4-layer config, the shape and survivor
  ranking, no duplicate when live docs < survivors, batched equal to the
  per-query loop, the plan and the cascade ledger equal to JAX's.
"""

import numpy as np
import pytest

from pathway_tpu.engine import probes as JP
from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.ops import fused_query as JF
from pathway_tpu_torch import CrossEncoderModel, FusedRAGPipeline, SentenceEmbedderModel
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.models.transformer import TransformerConfig
from pathway_tpu_torch.ops import fused_query as TF
from tests.torch_parity import configs, np_encoder_params, np_head, to_jax

TOL = 1e-4
CASCADE = dict(rerank_cascade_depth=0, rerank_cascade_survivors=0,
               rerank_seed_weight=0.25)


def _corpus(seed, n_docs, n_queries):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = np.array(sorted({
        "".join(rng.choice(letters, rng.integers(3, 9))) for _ in range(400)}))
    docs = [" ".join(rng.choice(words, int(rng.integers(4, 15)))) for _ in range(n_docs)]
    queries = [" ".join(rng.choice(words, 6)) for _ in range(n_queries)]
    return docs, queries


@pytest.fixture(scope="module")
def pipelines():
    """The JAX and the port pipelines over one seeded 200-doc corpus, f32,
    weights scaled up so scores spread beyond the tolerances."""
    jcfg, tcfg = configs("float32")
    e_np = np_encoder_params(seed=40, emb_std=1.0, w_std=0.3)
    r_np, head = np_encoder_params(seed=41, emb_std=1.0, w_std=0.3), np_head(42, 1.0)
    docs, queries = _corpus(seed=4, n_docs=200, n_queries=8)
    kw = dict(reserved_space=256, doc_seq=16, pair_seq=48)
    jtok = JTok(vocab_size=1000)
    jemb = JEmbed(jcfg, params=to_jax(e_np), tokenizer=jtok, max_length=32)
    jp = JF.FusedRAGPipeline(jemb, JCross(jcfg, params=to_jax(r_np), head=to_jax(head),
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


def _direct(tp, texts, k, pair_seq):
    ids, mask, _ = tp._tokenize_queries(
        texts, max_length=min(tp.embedder.max_length, tp._rerank_q_budget))
    e, r = tp.embedder, tp.reranker
    return TF._retrieve_rerank(
        e.params, ids, mask, tp.index._corpus, tp.index._valid, tp._doc_tokens,
        tp._doc_lens, r.params, r.head, e.cfg, r.cfg, k, tp.metric, pair_seq)


@pytest.mark.parametrize("pair_buckets", [False, True])
def test_cascade_off_is_the_plain_rerank_bitwise(pipelines, pair_buckets):
    _, tp, queries = pipelines
    tp.pair_buckets = pair_buckets
    try:
        assert tp.rerank_cascade is False  # the JAX default
        for texts in ([queries[0]], queries[:5]):
            got = tp.retrieve_rerank_batch_device(texts, 16)
            q_max = int(tp.embedder.tokenizer(
                texts, max_length=min(32, tp._rerank_q_budget))[1].sum(1).max())
            want = _direct(tp, texts, 16, tp._pair_bucket(q_max))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g.numpy(), w.numpy())
    finally:
        tp.pair_buckets = True


def _order_equal_up_to_ties(got, want, keys, tol=TOL):
    """``order`` rows equal, except that candidates whose deciding scores
    lie within ``tol`` of each other may swap."""
    for g_row, w_row, k_row in zip(got, want, keys):
        for j, (g, w) in enumerate(zip(g_row, w_row)):
            if g != w:
                assert abs(k_row[g] - k_row[w]) <= tol, (j, g, w)


@pytest.mark.parametrize("depth,keep,seed_w,k", [(1, 5, 0.25, 8), (1, 8, 0.0, 16),
                                                 (2, 4, 1.0, 8)])
def test_cascade_matches_jax(pipelines, depth, keep, seed_w, k):
    jp, tp, queries = pipelines
    arrays, k_eff, pair_seq = jp._rerank_args(queries, k)
    want = [np.asarray(a) for a in JF._fused_retrieve_rerank_cascade(
        *arrays, jp.embedder.cfg, jp.reranker.cfg, k_eff, jp.metric, pair_seq,
        depth, keep, seed_w)]
    tp.rerank_cascade, tp.rerank_cascade_depth = True, depth
    tp.rerank_cascade_survivors, tp.rerank_seed_weight = keep, seed_w
    try:
        got = [t.numpy() for t in tp.retrieve_rerank_batch_device(queries, k)]
    finally:
        tp.rerank_cascade = False
        tp.__dict__.update(CASCADE)
    n = len(queries)
    scores, idx, r_scores, order = (a[:n] for a in got)
    w_scores, w_idx, w_r, w_order = (a[:n] for a in want)
    assert np.array_equal(idx, w_idx)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_scores, w_r, rtol=0, atol=TOL)
    _order_equal_up_to_ties(order, w_order, w_r)
    for row in order:
        assert sorted(row.tolist()) == list(range(k))


def test_cascade_plan_and_ledger_match_jax(pipelines, monkeypatch):
    jp, tp, queries = pipelines
    for depth, keep in ((0, 0), (1, 0), (0, 3), (9, 99)):
        tp.rerank_cascade_depth, tp.rerank_cascade_survivors = depth, keep
        monkeypatch.setenv("PATHWAY_TPU_RERANK_CASCADE_DEPTH", str(depth))
        monkeypatch.setenv("PATHWAY_TPU_RERANK_CASCADE_SURVIVORS", str(keep))
        for k in (1, 8, 32):
            assert tp._cascade_plan(k) == jp._cascade_plan(k)
    tp.__dict__.update(CASCADE)
    for p, probes in ((tp, TP), (jp, JP)):
        probes.reset_cascade_stats()
        p._record_cascade(3, 16, 8, 1, 48)
        p._record_cascade(1, 8, 8, 2, 32)
    assert TP.cascade_stats() == JP.cascade_stats()
    assert TF._encoder_flops(tp.reranker.cfg, 48, 2, 5) == \
        JF._encoder_flops(jp.reranker.cfg, 48, 2, 5)
    # a cascaded query counts its dispatch kind and charges both stages
    TP.reset_cascade_stats()
    d0 = TP.dispatch_counts().get("fused_rerank_cascade", 0)
    tp.rerank_cascade = True
    try:
        tp.retrieve_rerank_batch(queries[:3], 8)
    finally:
        tp.rerank_cascade = False
    assert TP.dispatch_counts()["fused_rerank_cascade"] == d0 + 1
    assert TP.cascade_stats()["pairs"] == {"cheap": 24, "full": 24}


# ----------------------------------------------------------- the port alone

CFG = TransformerConfig(vocab_size=4096, hidden=128, layers=4, heads=4,
                        intermediate=256)


@pytest.fixture(scope="module")
def pipe():
    """tests/test_rerank_cascade.py's fixture on the port: a 4-layer
    random-init pipeline over 256 docs of varied length."""
    emb = SentenceEmbedderModel(cfg=CFG, max_length=32, device="cpu",
                                tokenizer=HashTokenizer(vocab_size=CFG.vocab_size))
    rr = CrossEncoderModel(cfg=CFG, tokenizer=emb.tokenizer, max_length=128, device="cpu")
    p = FusedRAGPipeline(emb, rr, reserved_space=256, doc_seq=24, pair_seq=64)
    rng = np.random.default_rng(3)
    words = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
                      "theta", "iota", "kappa", "mu", "nu", "stream", "index",
                      "query", "tensor"])
    docs = [" ".join(rng.choice(words, int(rng.integers(4, 21)))) for _ in range(256)]
    p.add([f"k{i}" for i in range(256)], docs)
    p.queries = [" ".join(rng.choice(words, 5)) for _ in range(10)]
    return p


def _cascade(p, on, depth=0, keep=0, seed_w=0.25):
    p.rerank_cascade, p.rerank_cascade_depth = on, depth
    p.rerank_cascade_survivors, p.rerank_seed_weight = keep, seed_w


def test_cascade_overlap_top8(pipe):
    """Mean top-8 overlap with the full rerank >= 0.9 at depth 3 of 4, 28
    of 32 surviving (JAX's bar for random-init weights)."""
    _cascade(pipe, False)
    full = [[key for key, _ in pipe.retrieve_rerank(q, k=32)[:8]] for q in pipe.queries]
    _cascade(pipe, True, depth=3, keep=28)
    try:
        overlaps = [len({key for key, _ in pipe.retrieve_rerank(q, k=32)[:8]} & set(w)) / 8
                    for q, w in zip(pipe.queries, full)]
    finally:
        _cascade(pipe, False)
    assert sum(overlaps) / len(overlaps) >= 0.9, overlaps


def test_cascade_shape_and_survivor_ranking(pipe):
    _cascade(pipe, True, depth=2, keep=8)
    try:
        out = pipe.retrieve_rerank(pipe.queries[1], k=16)
    finally:
        _cascade(pipe, False)
    assert len(out) == 16 and len({key for key, _ in out}) == 16
    surv = [s for _, s in out[:8]]
    assert surv == sorted(surv, reverse=True)


def test_cascade_small_corpus_no_duplicates():
    """Live docs < survivors: padded candidates survive, and ``order``
    stays a permutation (survivor slots rank strictly below padding)."""
    emb = SentenceEmbedderModel(cfg=CFG, max_length=32, device="cpu",
                                tokenizer=HashTokenizer(vocab_size=CFG.vocab_size))
    rr = CrossEncoderModel(cfg=CFG, tokenizer=emb.tokenizer, max_length=128, device="cpu")
    p = FusedRAGPipeline(emb, rr, reserved_space=32, doc_seq=24, pair_seq=64,
                         rerank_cascade=True)  # auto keep = max(8, k // 2) > 5 live
    p.add([f"k{i}" for i in range(5)], ["alpha beta", "gamma delta", "epsilon zeta",
                                        "eta theta", "iota kappa"])
    keys = [key for key, _ in p.retrieve_rerank("alpha query", k=32)]
    assert len(keys) == len(set(keys)) and set(keys) == {f"k{i}" for i in range(5)}
    for row in p.retrieve_rerank_batch(["alpha query", "gamma query"], k=32):
        rk = [key for key, _ in row]
        assert len(rk) == len(set(rk)) == 5, rk
    _, _, _, order = p.retrieve_rerank_batch_device(["alpha query"], 32)
    assert sorted(order[0].tolist()) == list(range(32))


@pytest.mark.parametrize("cascade", [False, True])
def test_batched_equals_per_query_loop(pipe, cascade):
    _cascade(pipe, cascade, depth=2, keep=8)
    try:
        texts = pipe.queries[:3]
        batched = pipe.retrieve_rerank_batch(texts, k=16)
        looped = [pipe.retrieve_rerank(t, k=16) for t in texts]
    finally:
        _cascade(pipe, False)
    for b, l in zip(batched, looped):
        assert [key for key, _ in b] == [key for key, _ in l]
        np.testing.assert_allclose([s for _, s in b], [s for _, s in l], rtol=0, atol=TOL)
