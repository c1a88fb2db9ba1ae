"""The port's training steps (``pathway_tpu_torch/models/train.py``)
against the JAX package's ``models/train.py``, on the CPU.

Both sides start from the JAX ``init_params`` carried over by
``models/params.py`` ``from_jax_params`` and take the same batches, made
from a seed with numpy. The parity bars run the f32 configs: the same f32
arithmetic summed in another order, so losses agree within 1e-5, gradient
leaves within ``atol=1e-5, rtol=1e-4`` and five-step trajectories within
1e-4 relative. Under ``tests/test_models.py``'s bf16 ``TINY`` the two
frameworks round activations at different places (XLA keeps some fused
elementwise chains in f32): the first loss differs by ~2.6e-3 there, so
that config is held to JAX's own bar (the loss falls) on the port alone.

Beside the parity: AdamW with optax's defaults (a zero-gradient step is
exactly optax's weight decay), the training forward never reaching the
``flash_attn`` seam, trained params read back into JAX, the dp x tp
sharded steps over ``[cpu] * 8`` equal to the unsharded step with bitwise
equal replicas, and the first steps of ``tests/test_rag_eval.py``'s
``trained_decoder`` recipe. The whole answer-accuracy gate trains for
minutes on the CPU and is marked ``slow``, as JAX's is; ``chip_smoke.py``
phase 24 (c) runs it on the card.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu.models import train as JT
from pathway_tpu.models import transformer as JTr
from pathway_tpu.models.tokenizer import HashTokenizer
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import flash_attention as TFA
from pathway_tpu_torch.models import train as TT
from pathway_tpu_torch.models import transformer as TTr
from pathway_tpu_torch.models.params import from_jax_params, to_numpy
from pathway_tpu_torch.parallel.mesh import ShardedTensor, _box, make_mesh, place_pytree
from tests import test_rag_eval as RE

_ENC = dict(layers=2, hidden=32, heads=4, intermediate=64, vocab_size=500, max_position=64)
J_TINY = dataclasses.replace(JTr.MINILM_L6, **_ENC, dtype=jnp.float32)
T_TINY = dataclasses.replace(TTr.MINILM_L6, **_ENC, dtype=torch.float32)
T_TINY_BF16 = dataclasses.replace(TTr.MINILM_L6, **_ENC)  # tests/test_models.py's TINY
_DEC = dict(vocab_size=64, hidden=32, layers=2, heads=4, intermediate=64, max_position=32)
J_DEC = JD.DecoderConfig(**_DEC, dtype=jnp.float32)  # tests/test_decoder.py:303
T_DEC = TD.DecoderConfig(**_DEC, dtype=torch.float32)
_SHD = dict(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64, max_position=64)
T_DEC_SHARDED = TD.DecoderConfig(**_SHD, dtype=torch.float32)  # tests/test_decoder.py:22
CPU8 = [torch.device("cpu")] * 8
CPU = "cpu"


def _t(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _port_state(jparams, lr):
    tx = TT.AdamW(lr)
    params = _t(jparams)
    return TT.TrainState(params, tx.init(params), 0), tx


def _contrastive_batch(n=4):
    tok = HashTokenizer(vocab_size=500, max_length=8)
    qi, qm = tok([f"query {i}" for i in range(n)], pad_to=8)
    di, dm = tok([f"document {i} and more" for i in range(n)], pad_to=8)
    return {k: np.asarray(v, np.int32) for k, v in
            dict(q_ids=qi, q_mask=qm, d_ids=di, d_mask=dm).items()}


def _lm_batch(vocab=64, rows=4, seq=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), np.int32)
    mask[0, :4] = 0  # one left-padded row
    return {"ids": ids, "mask": mask}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _grads_match(jgrads, tparams, tloss):
    names = list(_flat(tparams))
    leaves = list(_flat(tparams).values())
    tg = torch.autograd.grad(tloss, leaves, materialize_grads=True)
    jg = _flat(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, tg):
        np.testing.assert_allclose(g.numpy(), jg[name], atol=1e-5, rtol=1e-4, err_msg=name)


# ------------------------------------------------------------- contrastive


def test_contrastive_loss_and_grads_match_jax():
    jstate, _ = JT.init_train_state(jax.random.PRNGKey(0), J_TINY)
    batch = _contrastive_batch()
    batch["q_mask"][0, 3:] = 0
    jl, jg = jax.value_and_grad(JT.contrastive_loss)(jstate.params, _jb(batch), J_TINY)
    state, _ = _port_state(jstate.params, 2e-5)
    tl = TT.contrastive_loss(state.params, _tb(batch), T_TINY)
    assert abs(float(tl) - float(jl)) < 1e-5
    _grads_match(jg, state.params, tl)


def test_contrastive_five_steps_match_jax():
    jstate, jtx = JT.init_train_state(jax.random.PRNGKey(0), J_TINY, learning_rate=1e-3)
    state, tx = _port_state(jstate.params, 1e-3)
    jstep = jax.jit(JT.make_train_step(J_TINY, jtx))
    tstep = TT.make_train_step(T_TINY, tx)
    batch = _contrastive_batch()
    jl, tl = [], []
    for _ in range(5):
        jstate, a = jstep(jstate, _jb(batch))
        state, b = tstep(state, _tb(batch))
        jl.append(float(a))
        tl.append(float(b))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] and state.step == 5


def test_contrastive_training_reduces_loss_bf16():
    """JAX's ``test_contrastive_training_reduces_loss`` on the port, at its
    bf16 TINY (compute bf16, params f32)."""
    state, tx = TT.init_train_state(0, T_TINY_BF16, learning_rate=1e-3, device=CPU)
    step = TT.make_train_step(T_TINY_BF16, tx)
    batch = _tb(_contrastive_batch())
    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(t.dtype == torch.float32 for t in TT.param_leaves(state.params))


# ------------------------------------------------------------- decoder LM


def test_lm_loss_and_grads_match_jax():
    jstate, _ = JT.init_decoder_train_state(jax.random.PRNGKey(0), J_DEC)
    batch = _lm_batch()
    jl, jg = jax.value_and_grad(JT.lm_loss)(jstate.params, _jb(batch), J_DEC)
    state, _ = _port_state(jstate.params, 3e-4)
    tl = TT.lm_loss(state.params, _tb(batch), T_DEC)
    assert abs(float(tl) - float(jl)) < 1e-5
    _grads_match(jg, state.params, tl)


def test_lm_five_steps_match_jax():
    jstate, jtx = JT.init_decoder_train_state(jax.random.PRNGKey(0), J_DEC,
                                              learning_rate=1e-2)
    state, tx = _port_state(jstate.params, 1e-2)
    jstep = jax.jit(JT.make_decoder_train_step(J_DEC, jtx))
    tstep = TT.make_decoder_train_step(T_DEC, tx)
    batch = _lm_batch()
    jl, tl = [], []
    for _ in range(5):
        jstate, a = jstep(jstate, _jb(batch))
        state, b = tstep(state, _tb(batch))
        jl.append(float(a))
        tl.append(float(b))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_lm_training_overfits_tiny_batch_and_ignores_pads():
    """``tests/test_decoder.py::test_decoder_lm_training_overfits_tiny_batch``
    on the port: thirty steps at lr 1e-2 halve the loss, and what the pad
    positions hold does not change it."""
    jstate, _ = JT.init_decoder_train_state(jax.random.PRNGKey(0), J_DEC)
    state, tx = _port_state(jstate.params, 1e-2)
    step = TT.make_decoder_train_step(T_DEC, tx)
    batch = _tb(_lm_batch())
    losses = []
    for _ in range(30):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    garbage = dict(batch, ids=batch["ids"].clone())
    garbage["ids"][0, :4] = 63
    with torch.no_grad():
        l1 = float(TT.lm_loss(state.params, batch, T_DEC))
        l2 = float(TT.lm_loss(state.params, garbage, T_DEC))
    assert abs(l1 - l2) < 1e-5


# ------------------------------------------------------------- the optimiser


def test_adamw_takes_optax_defaults():
    sig = inspect.signature(optax.adamw).parameters
    tx = TT.AdamW(1e-3)
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (
        sig["b1"].default, sig["b2"].default, sig["eps"].default,
        sig["weight_decay"].default) == (0.9, 0.999, 1e-8, 1e-4)
    opt = tx.init({"w": torch.ones(3)})
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


def test_zero_gradient_step_is_optax_weight_decay():
    """With every gradient zero, AdamW's moments stay zero and a step moves
    each param by -lr * weight_decay * param only: the port's step equals
    optax's ``tx.update`` on the same tree."""
    lr = 1.0  # a decay of 1e-4 of each param, well above f32's resolution
    jstate, _ = JT.init_decoder_train_state(jax.random.PRNGKey(0), J_DEC)
    jtx = optax.adamw(lr)
    jp = jstate.params
    zeros = jax.tree.map(jnp.zeros_like, jp)
    updates, _ = jtx.update(zeros, jtx.init(jp), jp)
    want = _flat(jax.tree.map(np.asarray, optax.apply_updates(jp, updates)))
    before = _flat(jax.tree.map(np.asarray, jp))
    params = _t(jp)
    opt = TT.AdamW(lr).init(params)
    for t in TT.param_leaves(params):
        t.grad = torch.zeros_like(t)
    opt.step()
    got = _flat(to_numpy(params))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-12, err_msg=name)
        moved = got[name] - before[name]
        np.testing.assert_allclose(moved, -lr * 1e-4 * before[name],
                                   rtol=2e-3, atol=1e-12, err_msg=name)


# ------------------------------------------------------------- the dense core


def test_training_forward_never_calls_flash_attn(monkeypatch):
    """A step runs the dense core: a counting sentinel in place of the
    ``flash_attn`` seam of the encoder and the decoder sees no call, and
    the attention projections get a gradient (through the flash kernel on
    the card they would get none)."""
    calls = []

    def sentinel(*a, **k):
        calls.append(1)
        return TFA.flash_attn(*a, **k)

    monkeypatch.setattr(TTr, "flash_attn", sentinel)
    monkeypatch.setattr(TD, "flash_attn", sentinel)
    state, tx = TT.init_train_state(0, T_TINY, learning_rate=1e-3, device=CPU)
    batch = _tb(_contrastive_batch())
    qkv, out = state.params["layers"]["qkv_w"], state.params["layers"]["attn_out_w"]
    gq, go = torch.autograd.grad(TT.contrastive_loss(state.params, batch, T_TINY), [qkv, out])
    assert all(float(g[i].abs().max()) > 0 for g in (gq, go) for i in range(T_TINY.layers))
    TT.make_train_step(T_TINY, tx)(state, batch)
    dstate, dtx = TT.init_decoder_train_state(0, T_DEC, device=CPU)
    TT.make_decoder_train_step(T_DEC, dtx)(dstate, _tb(_lm_batch()))
    assert calls == []
    # the serving path keeps the seam
    TTr.encode(state.params, batch["q_ids"], batch["q_mask"], T_TINY)
    assert len(calls) == T_TINY.layers


def test_dense_core_averages_fully_padded_rows_as_jax():
    jparams = JTr.init_params(jax.random.PRNGKey(1), J_TINY)
    ids = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    mask = np.ones((2, 8), np.int32)
    mask[1] = 0  # a bucket's padding row
    want = np.asarray(JTr.encode(jparams, jnp.asarray(ids), jnp.asarray(mask), J_TINY))
    got = TTr.encode(_t(jparams), torch.from_numpy(ids), torch.from_numpy(mask), T_TINY,
                     flash=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_trained_params_read_back_into_jax():
    """The port's trained params, through ``to_numpy``, give JAX's encode
    and decoder forward the port's outputs."""
    state, tx = TT.init_train_state(0, T_TINY, learning_rate=1e-3, device=CPU)
    step = TT.make_train_step(T_TINY, tx)
    batch = _tb(_contrastive_batch())
    for _ in range(3):
        state, _ = step(state, batch)
    with torch.no_grad():
        got = TTr.encode(state.params, batch["d_ids"], batch["d_mask"], T_TINY, flash=False)
    want = JTr.encode(to_numpy(state.params), jnp.asarray(batch["d_ids"].numpy()),
                      jnp.asarray(batch["d_mask"].numpy()), J_TINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    dstate, dtx = TT.init_decoder_train_state(0, T_DEC, learning_rate=1e-2, device=CPU)
    dstep = TT.make_decoder_train_step(T_DEC, dtx)
    lm = _tb(_lm_batch())
    for _ in range(3):
        dstate, _ = dstep(dstate, lm)
    with torch.no_grad():
        got = TD.forward(dstate.params, lm["ids"], lm["mask"], T_DEC)
    want = JD.forward(to_numpy(dstate.params), jnp.asarray(lm["ids"].numpy()),
                      jnp.asarray(lm["mask"].numpy()), J_DEC)
    live = lm["mask"].numpy().astype(bool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=1e-5)


# ------------------------------------------------------------- sharded steps


def _replicas_equal_and_boxed(params, plain):
    """Every replica of a box holds bitwise the same values, each shard the
    shape of its box, and the gathered tensor the unsharded step's."""
    for name, st in _flat(params).items():
        assert isinstance(st, ShardedTensor), name
        assert len(set(st.index)) == st.mesh.size, name  # one tensor a position
        by_box = {}
        for p in range(st.mesh.size):
            box = _box(st.mesh, st.spec, st.global_shape, p)
            shard = st.shards[st.index[p]]
            assert tuple(shard.shape) == tuple(n for _, n in box), name
            first = by_box.setdefault(box, shard)
            assert torch.equal(first, shard), name
        np.testing.assert_allclose(st.gather().detach().numpy(),
                                   plain[name].detach().numpy(), atol=1e-5, err_msg=name)


def _sharded_against_plain(init, make_step, cfg, specs, batch, dp, tp):
    plain, ptx = init()
    pstep = make_step(cfg, ptx)
    state, tx = init()
    mesh = make_mesh(CPU8, dp=dp, tp=tp)
    params = place_pytree(state.params, mesh, specs, share=False)
    state = TT.TrainState(params, tx.init(params), 0)
    step = make_step(cfg, tx)
    losses, plain_losses = [], []
    for _ in range(2):
        state, loss = step(state, batch)
        plain, pl = pstep(plain, batch)
        losses.append(float(loss))
        plain_losses.append(float(pl))
    np.testing.assert_allclose(losses, plain_losses, rtol=1e-5)
    assert losses[1] < losses[0] and state.step == 2
    _replicas_equal_and_boxed(state.params, _flat(plain.params))


def test_dp_tp_sharded_contrastive_step_equals_unsharded():
    """``tests/test_parallel.py::test_dp_tp_sharded_train_step`` on the
    port: dp=4 x tp=2 over ``[cpu] * 8`` with the published specs."""
    tok = HashTokenizer(vocab_size=500, max_length=8)
    texts = [f"text {i}" for i in range(8)]
    qi, qm = tok(texts, pad_to=8)
    di, dm = tok([t + " doc" for t in texts], pad_to=8)
    batch = _tb(dict(q_ids=qi, q_mask=qm, d_ids=di, d_mask=dm))
    _sharded_against_plain(
        lambda: TT.init_train_state(0, T_TINY, learning_rate=1e-3, device=CPU),
        TT.make_train_step, T_TINY, TTr.param_partition_specs(T_TINY), batch, 4, 2)


def test_dp_tp_sharded_lm_step_equals_unsharded():
    """``tests/test_decoder.py::test_decoder_lm_train_step_dp_tp_sharded``
    on the port: dp=2 x tp=4, a left-padded row."""
    batch = _tb(_lm_batch(vocab=128))
    _sharded_against_plain(
        lambda: TT.init_decoder_train_state(0, T_DEC_SHARDED, device=CPU),
        TT.make_decoder_train_step, T_DEC_SHARDED, TD.param_partition_specs(T_DEC_SHARDED),
        batch, 2, 4)


# ------------------------------------------------------------- the RAG gate's decoder


J_GATE = JD.DecoderConfig(vocab_size=97, hidden=64, layers=2, heads=4, intermediate=128,
                          max_position=RE.SEQ + 16, dtype=jnp.float32)
T_GATE = TD.DecoderConfig(vocab_size=97, hidden=64, layers=2, heads=4, intermediate=128,
                          max_position=RE.SEQ + 16, dtype=torch.float32)


def _gate_batches(n_batches, n=64):
    """``trained_decoder``'s batches: 64 training samples drawn with
    ``np.random.default_rng(0)``, the decoder's view plus the answer."""
    tok = RE.CharTokenizer()
    rng = np.random.default_rng(0)
    for _ in range(n_batches):
        idx = rng.integers(0, len(RE.TRAIN_SAMPLES), n)
        seqs, lens = [], []
        for i in idx:
            s = RE.TRAIN_SAMPLES[int(i)]
            ids = tok.encode(RE._decoder_view(s) + " " + s.answer)[:RE.SEQ]
            lens.append(len(ids))
            seqs.append(ids + [0] * (RE.SEQ - len(ids)))
        mask = (np.arange(RE.SEQ)[None, :] < np.array(lens)[:, None]).astype(np.int32)
        yield {"ids": np.array(seqs, np.int32), "mask": mask}


def test_trained_decoder_recipe_first_steps_match_jax():
    jstate, jtx = JT.init_decoder_train_state(jax.random.PRNGKey(0), J_GATE,
                                              learning_rate=3e-3)
    state, tx = _port_state(jstate.params, 3e-3)
    jstep = jax.jit(JT.make_decoder_train_step(J_GATE, jtx))
    tstep = TT.make_decoder_train_step(T_GATE, tx)
    jl, tl = [], []
    for batch in _gate_batches(5):
        jstate, a = jstep(jstate, _jb(batch))
        state, b = tstep(state, _tb(batch))
        jl.append(float(a))
        tl.append(float(b))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_chip_smoke_gate_init_equals_jax_prngkey0():
    """``chip_smoke.py`` phase 24 (c) starts from the fixture's weights,
    drawn in numpy (threefry and XLA's erfinv): JAX's ``init_params``
    under ``PRNGKey(0)`` to within f32 rounding of the erfinv."""
    import chip_smoke

    want = _flat(jax.tree.map(np.asarray, JD.init_params(jax.random.PRNGKey(0), J_GATE)))
    got = _flat(chip_smoke.p24_fixture_params(T_GATE))
    assert want.keys() == got.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=2e-8, err_msg=name)
    b1, b2 = chip_smoke.p24_threefry((0, 0), 8)
    assert np.array_equal(np.stack([b1, b2], 1), np.asarray(jax.random.split(
        jax.random.PRNGKey(0), 8)))


@pytest.mark.slow
def test_rag_answer_accuracy_gate():
    """``tests/test_rag_eval.py::test_rag_answer_accuracy_gate`` on the
    port: the tiny decoder trained from the fixture's initial weights on
    the answer-copy task (its recipe), served by ``DecoderChat`` behind
    BM25 retrieval over the 40 held-out facts, must answer at least 60%."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
    from pathway_tpu_torch.xpacks.llm import rag_eval
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer,
        SimpleContextProcessor,
    )

    jparams = JD.init_params(jax.random.PRNGKey(0), J_GATE)  # the fixture's init
    state, tx = _port_state(jparams, 3e-3)
    step = TT.make_decoder_train_step(T_GATE, tx)
    loss = None
    for i, batch in enumerate(_gate_batches(900), start=1):
        state, loss = step(state, _tb(batch))
        if i % 30 == 0 and float(loss) < 0.21:
            break
    assert float(loss) < 0.3, f"decoder failed to learn the task: {float(loss)}"
    pw.clear_graph()
    store = DocumentStore(rag_eval.docs_table(RE.EVAL_SAMPLES),
                          retriever_factory=TantivyBM25Factory())
    chat = DecoderChat(params=state.params, cfg=T_GATE, tokenizer=RE.CharTokenizer(),
                       max_new_tokens=6, device=CPU)
    qa = BaseRAGQuestionAnswerer(chat, store, search_topk=1, prompt_template=RE.TEMPLATE,
                                 context_processor=SimpleContextProcessor())
    out = rag_eval.run_rag_eval(qa, RE.EVAL_SAMPLES)
    assert out["n"] == len(RE.EVAL_SAMPLES)
    assert out["accuracy_contains"] >= RE.MIN_ACCURACY, out
