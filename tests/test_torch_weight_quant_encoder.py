"""The port's int8 encoder weights against the JAX package (after the
encoder cases of tests/test_weight_quant.py).

Tolerances, each with its reason:
* ``_wq_quant`` and ``quantize_encoder_params``: int8 payloads equal, f32
  scales within 1e-7 (the same f32 max, division and round-half-even);
* ``encode`` on one quantized tree, f32 compute: atol 1e-5, the bar of
  tests/test_checkpoint.py (summation order only);
* bf16 compute: rtol 2**-7 plus atol 4e-2, and a mean error under 1e-2:
  the port rounds the same f32 product, scales and casts in JAX's order,
  but the two frameworks sum in different orders, which moves a bf16
  result by an ulp or two; at these weights (hidden states up to ~3, where
  a bf16 ulp is 1.6e-2) the unquantized bf16 encoder differs from JAX's by
  the same 3.1e-2 at most;
* embedder vectors (bf16, int8 on both sides): cosine >= 0.999, and each
  side within cosine 0.99 of its own bf16 vectors (the JAX test's quality
  bar);
* cross-encoder scores (f32, int8): atol 1e-4 (tests/test_torch_rag.py's).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pathway_tpu.models import transformer as JT
from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.embedder import cast_params_for_inference as j_cast
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu_torch import CrossEncoderModel, SentenceEmbedderModel
from pathway_tpu_torch.engine import probes as TP
from pathway_tpu_torch.models import transformer as TT
from pathway_tpu_torch.models.embedder import cast_params_for_inference as t_cast
from pathway_tpu_torch.models.embedder import embed_fn
from pathway_tpu_torch.models.params import from_jax_params, to_numpy
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from tests.torch_parity import configs, np_encoder_params, np_head, to_jax

BF16_ULP = 2.0 ** -7
TEXTS = ["weight only int8", "the quick brown fox jumps over the lazy dog",
         "retrieval on a gpu", "a", "café naïve résumé", "one two three four five"]


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for name in w:
        a, b = np.asarray(g[name]), np.asarray(w[name])
        assert a.shape == b.shape, name
        if b.dtype == np.int8:
            assert a.dtype == np.int8 and np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=0, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("shape,axis", [((7, 5), -1), ((2, 16, 24), -2),
                                        ((3, 40, 8), -1), ((1, 1, 9), -2)])
def test_wq_quant_matches_jax(shape, axis):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    w = rng.normal(0.0, 0.05, shape).astype(np.float32)
    w.flat[0] = 0.0
    if shape[0] > 1:
        w[0] = 0.0  # an all-zero channel: the scale floor
    jq, js = JT._wq_quant(jnp.asarray(w), axis=axis)
    tq, ts = TT._wq_quant(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    assert ts.shape[axis] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_encoder_params_matches_jax(dtype):
    jcfg, tcfg = configs(dtype)
    npp = np_encoder_params(seed=5, emb_std=0.5, w_std=0.2)
    want = JT.quantize_encoder_params(to_jax(npp))
    got = TT.quantize_encoder_params(from_jax_params(npp))
    assert TT.encoder_params_quantized(got) and not TT.encoder_params_quantized(
        from_jax_params(npp))
    _assert_trees_equal(to_numpy(got), jax.tree.map(np.asarray, want))
    # the embedder's form: scales from the full-precision tree, every other
    # leaf from the compute-dtype cast
    want = JT.quantize_encoder_params(to_jax(npp), out=j_cast(to_jax(npp), jcfg))
    got = TT.quantize_encoder_params(from_jax_params(npp),
                                     out=t_cast(from_jax_params(npp), tcfg))
    _assert_trees_equal(to_numpy(got), jax.tree.map(np.asarray, want))
    for name, leaf in _leaves(got):
        base = name.rsplit("/", 1)[1]
        if base in ("word",) + TT._WQ_ENC_LAYER_WEIGHTS:
            assert leaf.dtype == torch.int8, name
        elif base.endswith("_scale") and base[:-6] in ("word",) + TT._WQ_ENC_LAYER_WEIGHTS:
            assert leaf.dtype == torch.float32, name
        else:
            assert leaf.dtype == getattr(torch, dtype), name


def test_quantized_tree_crosses_from_jax_bit_for_bit():
    npp = np_encoder_params(seed=6)
    jq = jax.tree.map(np.asarray, JT.quantize_encoder_params(to_jax(npp)))
    tq = from_jax_params(jq)
    assert tq["embeddings"]["word"].dtype == torch.int8
    assert tq["embeddings"]["word_scale"].dtype == torch.float32
    _assert_trees_equal(to_numpy(tq), jq)


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=0, atol=1e-5)),
                                       ("bfloat16", dict(rtol=BF16_ULP, atol=4e-2))])
def test_encode_on_a_quantized_tree_matches_jax(dtype, tol):
    jcfg, tcfg = configs(dtype)
    npp = np_encoder_params(seed=7, emb_std=0.5, w_std=0.2)
    jq = JT.quantize_encoder_params(to_jax(npp))
    tq = TT.quantize_encoder_params(from_jax_params(npp))
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 1000, (3, 24)).astype(np.int32)
    mask = np.ones((3, 24), np.int32)
    mask[1, 20:] = 0
    types = (np.arange(24)[None, :] >= 12).astype(np.int32).repeat(3, 0)
    for tt in (None, types):
        want = np.asarray(JT.encode(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                    None if tt is None else jnp.asarray(tt)))
        got = TT.encode(tq, torch.from_numpy(ids), torch.from_numpy(mask), tcfg,
                        None if tt is None else torch.from_numpy(tt)).numpy()
        live = mask.astype(bool)
        np.testing.assert_allclose(got[live], want[live], **tol)
        assert np.abs(got[live] - want[live]).mean() < 1e-2


def test_embedding_dequant_promotes_the_residual_to_f32():
    """JAX's dequantized rows are f32 and ``rows + position`` promotes the
    sum; the port's too (only the gathered rows are scaled)."""
    _, tcfg = configs("bfloat16")
    npp = np_encoder_params(seed=8, emb_std=0.5)
    params = TT.quantize_encoder_params(from_jax_params(npp),
                                        out=t_cast(from_jax_params(npp), tcfg))
    ids = torch.tensor([[3, 999, 0, 17]])
    emb = params["embeddings"]
    rows = emb["word"][ids].float() * emb["word_scale"][ids]
    assert (rows + emb["position"][:4][None]).dtype == torch.float32
    x = TT.embed_inputs(params, ids, tcfg)
    jx, _ = JT.embed_inputs(
        JT.quantize_encoder_params(to_jax(npp), out=j_cast(to_jax(npp), configs("bfloat16")[0])),
        jnp.asarray(ids.numpy()), jnp.ones((1, 4), jnp.int32), configs("bfloat16")[0])
    np.testing.assert_allclose(x.float().numpy(), np.asarray(jx, np.float32),
                               rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("off", [None])
def test_weight_quant_off_is_byte_identical(off):
    """``None`` leaves the tree unquantized and the vectors those of the
    unquantized path computed by hand."""
    _, tcfg = configs("bfloat16")
    npp = np_encoder_params(seed=9)
    tok = HashTokenizer(vocab_size=1000)
    m = SentenceEmbedderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                              max_length=32, device="cpu", pipeline=False,
                              weight_quant=off)
    assert m.weight_quant == "" and not TT.encoder_params_quantized(m.params)
    assert not any(n.endswith("_scale") and "ln" not in n for n, _ in _leaves(m.params))
    ids, mask = m.tokenize(TEXTS)
    want = embed_fn(t_cast(from_jax_params(npp), tcfg), ids, mask, tcfg)
    got, _ = m.embed_device(TEXTS)
    assert torch.equal(got, want)
    base = SentenceEmbedderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                                 max_length=32, device="cpu", pipeline=False)
    assert np.array_equal(m.embed_batch(TEXTS), base.embed_batch(TEXTS))


# the port reads no environment variable: JAX's flag spellings are not
# arguments here
@pytest.mark.parametrize("bad", ["int4", "fp8", 3, "", "0", False, "off", True, "1", "INT8"])
def test_weight_quant_rejects_other_values(bad):
    _, tcfg = configs("float32")
    with pytest.raises(ValueError, match="weight_quant"):
        SentenceEmbedderModel(tcfg, device="cpu", weight_quant=bad)
    with pytest.raises(ValueError, match="weight_quant"):
        CrossEncoderModel(tcfg, device="cpu", weight_quant=bad)


def _param_bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree))


def test_embedder_int8_branch_matches_jax_and_its_ledger(monkeypatch):
    jcfg, tcfg = configs("bfloat16")
    npp = np_encoder_params(seed=12, emb_std=0.5, w_std=0.2)
    tok = HashTokenizer(vocab_size=1000)
    TP.reset_hbm_stats()
    tm = SentenceEmbedderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                               max_length=32, device="cpu", weight_quant="int8")
    try:
        assert tm.weight_quant == "int8" and TT.encoder_params_quantized(tm.params)
        emb = tm.params["embeddings"]
        assert emb["word"].dtype == torch.int8 and emb["word_scale"].dtype == torch.float32
        assert tm.params["layers"]["qkv_w"].dtype == torch.int8
        assert emb["position"].dtype == torch.bfloat16
        ledger = TP.hbm_stats()["current_bytes"]["weights.embedder"]
        int8 = sum(t.numel() for n, t in _leaves(tm.params) if t.dtype == torch.int8)
        scales = sum(t.numel() * 4 for n, t in _leaves(tm.params)
                     if n.endswith("_scale") and t.dtype == torch.float32)
        rest = sum(t.numel() * t.element_size() for n, t in _leaves(tm.params)
                   if t.dtype == torch.bfloat16)
        assert ledger == int8 + scales + rest == _param_bytes(tm.params)
        got = tm.embed_batch(TEXTS)
    finally:
        tm.close()
    monkeypatch.setenv("PATHWAY_TPU_WEIGHT_QUANT", "int8")
    jm = JEmbed(jcfg, params=to_jax(npp), tokenizer=JTok(vocab_size=1000), max_length=32)
    try:
        assert JT.encoder_params_quantized(jm.params)
        want = jm.embed_batch(TEXTS)
    finally:
        jm.close()
    cos = np.sum(got * want, axis=1)
    assert cos.min() >= 0.999, cos
    plain = SentenceEmbedderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                                  max_length=32, device="cpu", pipeline=False)
    assert np.sum(got * plain.embed_batch(TEXTS), axis=1).min() >= 0.99


def test_cross_encoder_int8_branch_matches_jax_and_its_ledger(monkeypatch):
    jcfg, tcfg = configs("float32")
    npp, head = np_encoder_params(seed=13, emb_std=0.5, w_std=0.2), np_head(14, 1.0)
    pairs = [(q, d) for q in TEXTS[:3] for d in TEXTS[3:]]
    TP.reset_hbm_stats()
    tm = CrossEncoderModel(tcfg, params=from_jax_params(npp), head=from_jax_params(head),
                           tokenizer=HashTokenizer(vocab_size=1000), device="cpu",
                           weight_quant="int8")
    assert TT.encoder_params_quantized(tm.params)
    assert tm.params["pooler"]["w"].dtype == torch.float32
    assert TP.hbm_stats()["current_bytes"]["weights.reranker"] == _param_bytes(tm.params)
    got = tm.score_batch(pairs)
    monkeypatch.setenv("PATHWAY_TPU_WEIGHT_QUANT", "int8")
    jm = JCross(jcfg, params=to_jax(npp), head=to_jax(head), tokenizer=JTok(vocab_size=1000))
    assert JT.encoder_params_quantized(jm.params)
    np.testing.assert_allclose(got, jm.score_batch(pairs), rtol=0, atol=1e-4)
    full = CrossEncoderModel(tcfg, params=from_jax_params(npp), head=from_jax_params(head),
                             tokenizer=HashTokenizer(vocab_size=1000), device="cpu")
    assert _param_bytes(full.params) > _param_bytes(tm.params)


def test_two_live_encoders_keep_their_own_ledger_entries():
    """Each embedder and cross-encoder records its weights under its own
    owner: the ledger holds both arms at once, and ``close()`` drops one."""
    _, tcfg = configs("bfloat16")
    npp = np_encoder_params(seed=15)
    tok = HashTokenizer(vocab_size=1000)
    TP.reset_hbm_stats()
    full, q8 = (SentenceEmbedderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                                      max_length=32, device="cpu", weight_quant=wq)
                for wq in (None, "int8"))
    ce_full, ce_q8 = (CrossEncoderModel(tcfg, params=from_jax_params(npp), tokenizer=tok,
                                        device="cpu", weight_quant=wq)
                      for wq in (None, "int8"))
    assert len({m.hbm_owner for m in (full, q8, ce_full, ce_q8)}) == 4
    assert TP.hbm_owner_bytes(full.hbm_owner) == {"weights.embedder": _param_bytes(full.params)}
    assert TP.hbm_owner_bytes(q8.hbm_owner) == {"weights.embedder": _param_bytes(q8.params)}
    assert TP.hbm_owner_bytes(ce_q8.hbm_owner) == {
        "weights.reranker": _param_bytes(ce_q8.params)}
    cur = TP.hbm_stats()["current_bytes"]
    assert cur["weights.embedder"] == _param_bytes(full.params) + _param_bytes(q8.params)
    assert cur["weights.reranker"] == _param_bytes(ce_full.params) + _param_bytes(ce_q8.params)
    full.close()
    ce_q8.close()
    cur = TP.hbm_stats()["current_bytes"]
    assert TP.hbm_owner_bytes(full.hbm_owner) == {}
    assert cur["weights.embedder"] == _param_bytes(q8.params)
    assert cur["weights.reranker"] == _param_bytes(ce_full.params)
    q8.close()
    ce_full.close()
    assert TP.hbm_stats()["current_bytes"] == {}
