"""The port's GPT-2-family decoder (pathway_tpu_torch/models/decoder.py)
against the JAX package's, on shared weights at a small width.

Weights come from the JAX ``init_params`` and reach the port through the
params bridge; inputs are made from a seed with numpy. Tolerances: f32
configs agree within 1e-5 (the same f32 arithmetic, summed in another
order); a bf16 config within 5e-2 on logits of magnitude ~1 (bf16 rounds
the activations at every product, in other places in the two frameworks).
Greedy tokens must be equal. Sampling draws differ across frameworks (the
PRNGs differ), so it is tested on the port side alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu.models.bpe import BPETokenizer as JBPE
from pathway_tpu_torch.models import bpe as TB
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from tests.test_decoder import _toy_bpe_dir

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=64, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                        intermediate=64, max_position=64, dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


def _prompts(B=3, S=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, JCFG.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(1, B):  # ragged left padding
        mask[b, : 2 * b] = 0
        ids[b, : 2 * b] = 0
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_match_jax(jparams, tparams, flash):
    ids, mask = _prompts()
    want = np.asarray(JD.forward(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                 JCFG, flash=flash))
    got = TD.forward(tparams, _t(ids), _t(mask), TCFG, flash=flash).numpy()
    live = mask.astype(bool)  # flash: fully masked rows are zeros by design
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_logits_and_cache_match_jax(jparams, tparams, flash):
    ids, mask = _prompts(seed=1)
    jl, jc = JD.prefill(jparams, jnp.asarray(ids), jnp.asarray(mask), JCFG,
                        16, flash=flash)
    tl, tc = TD.prefill(tparams, _t(ids), _t(mask), TCFG, 16, flash=flash)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["k"].shape == (2, 3, 4, 16, 8)
    live = np.broadcast_to(np.pad(mask, ((0, 0), (0, 7)))[None, :, None, :, None],
                           tc["k"].shape).astype(bool)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[live],
                                   np.asarray(jc[name])[live], **TOL)


def test_decode_step_matches_jax(jparams, tparams):
    ids, mask = _prompts(seed=2)
    S = ids.shape[1]
    _, jc = JD.prefill(jparams, jnp.asarray(ids), jnp.asarray(mask), JCFG, S + 4)
    _, tc = TD.prefill(tparams, _t(ids), _t(mask), TCFG, S + 4)
    tok = np.array([5, 17, 99], np.int32)
    pos = mask.sum(1).astype(np.int32)
    sm = np.pad(mask, ((0, 0), (0, 4)))
    sm[:, S] = 1
    for n_layers in (None, 1):
        jl, _ = JD.decode_step(jparams, jnp.asarray(tok), jnp.asarray(pos), S,
                               jnp.asarray(sm), jc, JCFG, n_layers=n_layers)
        tl, _ = TD.decode_step(tparams, _t(tok), _t(pos), S, _t(sm),
                               {k: v.clone() for k, v in tc.items()}, TCFG,
                               n_layers=n_layers)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_generate_greedy_tokens_equal_jax(jparams, tparams):
    ids, mask = _prompts(seed=3)
    want = np.asarray(JD.generate(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                  JCFG, 12))
    got = TD.generate(tparams, _t(ids), _t(mask), TCFG, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_eos_path_equal_jax(jparams, tparams):
    ids, mask = _prompts(seed=4)
    free = np.asarray(JD.generate(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                  JCFG, 10))
    eos = int(free[0, 3])  # a token row 0 emits mid-stream
    want = np.asarray(JD.generate(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                  JCFG, 10, eos_id=eos))
    got = TD.generate(tparams, _t(ids), _t(mask), TCFG, 10, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 4:] == eos).all()


def test_generate_rejects_overlong(tparams):
    ids, mask = _prompts()
    with pytest.raises(ValueError, match="max_position"):
        TD.generate(tparams, _t(ids), _t(mask), TCFG, 60)


def test_filter_logits_masks_equal_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (4, 50)).astype(np.float32)
    for top_k, top_p in ((5, None), (None, 0.7), (10, 0.5), (1, None)):
        want = np.asarray(JD._filter_logits(jnp.asarray(logits), top_k, top_p))
        got = TD._filter_logits(_t(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sampling_port_side(tparams):
    """Same generator seed, same draws; another seed, other draws; top_k=1
    is greedy; every draw lies in the top-k set."""
    ids, mask = _prompts(seed=6)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return TD.generate(tparams, _t(ids), _t(mask), TCFG, 10,
                           temperature=0.9, generator=g, **kw).numpy()

    a, b, c = run(1), run(1), run(2)
    assert (a == b).all() and (a != c).any()
    greedy = TD.generate(tparams, _t(ids), _t(mask), TCFG, 10).numpy()
    np.testing.assert_array_equal(run(3, top_k=1), greedy)
    logits = torch.randn((64, 128), generator=torch.Generator().manual_seed(0))
    draws = TD._sample_fn(1.0, 4, None)(logits, torch.Generator().manual_seed(0))
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert (top4 == draws[:, None].long()).any(dim=1).all()


def test_quantize_params_equal_jax(jparams, tparams):
    jq = JD.quantize_params(jparams, JCFG)
    tq = TD.quantize_params(tparams, TCFG)
    assert TD.params_quantized(tq) and not TD.params_quantized(tparams)
    np.testing.assert_array_equal(tq["wte"].numpy(), np.asarray(jq["wte"]))
    np.testing.assert_allclose(tq["wte_scale"].numpy(), np.asarray(jq["wte_scale"]),
                               rtol=1e-7)
    for name in TD._WQ_LAYER_WEIGHTS:
        assert tq["layers"][name].dtype == torch.int8
        np.testing.assert_array_equal(tq["layers"][name].numpy(),
                                      np.asarray(jq["layers"][name]))
        assert tq["layers"][name + "_scale"].shape == (2, 1, jparams["layers"][name].shape[-1])


@pytest.mark.parametrize("wq_kernel", [False, True])
def test_int8_weight_forward_matches_jax(jparams, tparams, wq_kernel):
    """The int8 seam (the einsum path, and the kernel route whose plain
    version runs on the CPU) gives the JAX logits."""
    ids, mask = _prompts(seed=7)
    jq = JD.quantize_params(jparams, JCFG)
    tq = from_jax_params(jax.tree.map(np.asarray, jq))
    jcfg = dataclasses.replace(JCFG, wq_kernel=wq_kernel)
    tcfg = dataclasses.replace(TCFG, wq_kernel=wq_kernel)
    jl, _ = JD.prefill(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, 12)
    tl, _ = TD.prefill(tq, _t(ids), _t(mask), tcfg, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    want = np.asarray(JD.generate(jq, jnp.asarray(ids), jnp.asarray(mask), jcfg, 8))
    np.testing.assert_array_equal(TD.generate(tq, _t(ids), _t(mask), tcfg, 8).numpy(),
                                  want)


def test_bf16_forward_close_to_jax(jparams):
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    jp = JD.cast_params_for_inference(jparams, jcfg)
    tp = TD.cast_params_for_inference(
        from_jax_params(jax.tree.map(np.asarray, jparams)), tcfg)
    assert tp["wte"].dtype == torch.bfloat16
    assert tp["layers"]["ln1_scale"].dtype == torch.float32
    ids, mask = _prompts(seed=8)
    want = np.asarray(JD.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = TD.forward(tp, _t(ids), _t(mask), tcfg).numpy()
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=5e-2)


def test_bpe_ids_equal_jax(tmp_path):
    d = _toy_bpe_dir(tmp_path)
    mine, ref = TB.BPETokenizer.from_dir(d), JBPE.from_dir(d)
    assert mine.eos_id == ref.eos_id and mine.vocab_size == ref.vocab_size
    rng = np.random.default_rng(1)
    alpha = list("the and willing 0123,!?'é中\n\t") + ["the", " the", "'s"]
    for _ in range(200):
        s = "".join(rng.choice(alpha) for _ in range(rng.integers(0, 25)))
        assert mine.encode(s) == ref.encode(s), s
        assert mine.decode(mine.encode(s)) == ref.decode(ref.encode(s))
    assert TB.pretokenize("it's  the 123 end") == ["it", "'s", " ", " the", " 123", " end"]
