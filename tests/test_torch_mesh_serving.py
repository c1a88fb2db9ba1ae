"""The port's serving mesh against its own mesh-off arm and the JAX
package's mesh (``tests/test_mesh_serving.py`` and the mesh cases of
``tests/test_weight_quant.py``).

The port's meshes are virtual positions on the CPU (``[cpu] * 8``), the
counterpart of the conftest's 8 host devices the JAX side runs on:

* the helpers and the typed validation, case by case against JAX's;
* the trivial mesh (one position) serves the mesh-off token streams byte
  for byte across the paged x spec x prefix grid;
* on ``(data=1, fsdp=2, tp=4)``, greedy paged-kernel decode (int8 K/V off
  and on) emits the port's single-device tokens AND JAX's ``mesh8``
  ``pool_decode_chunk`` tokens on the same weights; logits within 1e-5;
* continuous serving on that mesh, with int8 weights too, emits the
  single-device streams (held against the port's mesh-off arm: the JAX
  continuous server is not the reference, ROADMAP C);
* per-position HBM bytes, sharded int8 encoders, the checkpoint layouts,
  and retrieval through the sharded IVF mirror.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu.models import transformer as JT
from pathway_tpu.parallel import mesh as JM
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import transformer as TT
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.parallel.mesh import (
    MeshShapeError,
    P,
    ShardedTensor,
    make_serving_mesh,
    mesh_is_trivial,
    spec_dropping_nondividing,
    spec_with_fsdp,
)
from pathway_tpu_torch.xpacks.llm import DecoderChat
from tests.utils import ToyCharTokenizer

JCFG = JD.DecoderConfig(vocab_size=128, hidden=32, layers=4, heads=4,
                        intermediate=64, max_position=128, dtype=jnp.float32)
TCFG = TD.DecoderConfig(vocab_size=128, hidden=32, layers=4, heads=4,
                        intermediate=64, max_position=128, dtype=torch.float32)
N_SLOTS, CACHE_LEN, BLOCK = 4, 96, 16
CPU = torch.device("cpu")
PROMPTS = ["hello world", "mesh serving", "abc", "slot pool"]


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


def _mesh8():
    """data=1 fsdp=2 tp=4: heads, intermediate and vocab divide tp=4, and
    fsdp=2 exercises the ZeRO-3 overlay axis."""
    return make_serving_mesh([CPU] * 8, data=1, fsdp=2, tp=4)


def _mesh1():
    return make_serving_mesh([CPU], data=1, fsdp=1, tp=1)


def _jmesh8():
    return JM.make_serving_mesh(jax.devices(), data=1, fsdp=2, tp=4)


# -- helper units ------------------------------------------------------------


def test_mesh_trivial_predicate():
    assert mesh_is_trivial(None)
    assert mesh_is_trivial(_mesh1())
    assert not mesh_is_trivial(_mesh8())


@pytest.mark.parametrize("spec,shape,fsdp", [
    (("tp", None), (6, 8), 2), ((None, "tp"), (6, 8), 2), ((None, "tp"), (7, 8), 2),
    (("tp",), (8,), 1), ((None, None, "tp"), (4, 32, 96), 2)])
def test_spec_with_fsdp_matches_jax(spec, shape, fsdp):
    got = spec_with_fsdp(P(*spec), shape, fsdp)
    want = JM.spec_with_fsdp(JM.P(*spec), shape, fsdp)
    assert tuple(got) == tuple(want)
    assert tuple(spec_with_fsdp(P(None, "tp"), (6, 8), 2)) == ("fsdp", "tp")


@pytest.mark.parametrize("spec,shape", [
    (("tp", None), (8, 3)), (("tp", None), (30522, 3)),
    ((("fsdp", "tp"), None), (16, 3)), ((("fsdp", "tp"), None), (12, 3))])
def test_spec_dropping_nondividing_matches_jax(spec, shape):
    got = spec_dropping_nondividing(P(*spec), shape, _mesh8())
    want = JM.spec_dropping_nondividing(JM.P(*spec), shape, _jmesh8())
    assert tuple(got) == tuple(want)


def test_decoder_mesh_validation_is_typed():
    with pytest.raises(MeshShapeError) as exc_info:  # heads=4 cannot split 8 ways
        TD.validate_decoder_mesh(TCFG, make_serving_mesh([CPU] * 8, tp=8))
    assert exc_info.value.tp == 8 and exc_info.value.n_devices == 8
    TD.validate_decoder_mesh(TCFG, _mesh8())
    with pytest.raises(MeshShapeError):
        make_serving_mesh([CPU] * 8, data=3)


def test_param_mesh_specs_match_jax_and_cover_scales(jparams, tparams):
    """Every leaf, int8 scale planes included, gets JAX's spec."""
    jq, tq = JD.quantize_params(jparams, JCFG), TD.quantize_params(tparams, TCFG)
    jspecs = JD.param_mesh_specs(jq, JCFG, _jmesh8())
    tspecs = TD.param_mesh_specs(tq, TCFG, _mesh8())

    def flat(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    t_flat, j_flat = dict(flat(tspecs)), dict(flat(jspecs))
    assert set(t_flat) == set(j_flat) == {k for k, _ in flat(tq)}
    for key in t_flat:
        assert tuple(t_flat[key]) == tuple(j_flat[key]), key
    assert tuple(t_flat["layers/qkv_w_scale"]) == ("fsdp", None, "tp")


# -- the trivial mesh: byte-identical to no mesh -----------------------------


def _serve(params, prompts, **kw):
    kw.setdefault("prefill_chunk", 8)
    chat = DecoderChat(params=params, cfg=TCFG, tokenizer=ToyCharTokenizer(96),
                       max_new_tokens=8, temperature=0.0, max_prompt_tokens=96,
                       continuous=True, n_slots=4, chunk_steps=4, pipeline_depth=2,
                       device="cpu", **kw)
    try:
        out = []
        for p in prompts:
            r = chat.submit_batch([p])[0]
            assert r.done.wait(timeout=120)
            out.append(r.text)
        return out, chat.server
    finally:
        chat.close()


@pytest.mark.parametrize("paged_kv", [False, True])
@pytest.mark.parametrize("spec_decode", [False, True])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_trivial_mesh_serving_byte_identical(tparams, paged_kv, spec_decode, prefix_cache):
    kw = dict(paged_kv=paged_kv, spec_decode=spec_decode, prefix_cache=prefix_cache)
    baseline, _ = _serve(tparams, PROMPTS, **kw)
    on_mesh, srv = _serve(tparams, PROMPTS, mesh=_mesh1(), **kw)
    assert on_mesh == baseline
    assert not any(isinstance(v, ShardedTensor) for v in srv.pool.values())


# -- mesh8 decode against the single device and JAX's mesh8 -------------------


def _full_table(n_slots=N_SLOTS):
    M = CACHE_LEN // BLOCK
    return 1 + np.arange(n_slots * M, dtype=np.int32).reshape(n_slots, M)


def _admit_inputs():
    S = 16
    rng = np.random.default_rng(3)
    ids = np.zeros((N_SLOTS, S), np.int32)
    mask = np.zeros((N_SLOTS, S), np.int32)
    for r, n in enumerate([6, 10, 4, 8]):
        ids[r, S - n:] = rng.integers(1, 97, n)
        mask[r, S - n:] = 1
    return ids, mask


def _t_pool(params, kv_quant, mesh=None):
    pool = TD.paged_pool_init(params, TCFG, N_SLOTS, CACHE_LEN,
                              n_blocks=N_SLOTS * (CACHE_LEN // BLOCK) + 1, block=BLOCK,
                              kv_quant=kv_quant)
    pool["block_tbl"] = torch.from_numpy(_full_table())
    pool = TD.shard_pool(pool, TCFG, mesh)
    ids, mask = _admit_inputs()
    return TD.pool_admit_batch(params, torch.from_numpy(ids), torch.from_numpy(mask),
                               pool, torch.arange(N_SLOTS), TCFG, mesh=mesh)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mesh8_paged_kernel_tokens_match_single_device_and_jax(jparams, tparams, kv_quant):
    act = torch.ones((N_SLOTS,), dtype=torch.bool)
    base_pool = _t_pool(tparams, kv_quant)
    base_pool, base_toks = TD.pool_decode_chunk(tparams, base_pool, act, None, TCFG, 16,
                                                paged_kernel=True)
    mesh = _mesh8()
    params_sh = TD.shard_decoder_params(tparams, TCFG, mesh)
    pool_sh = _t_pool(params_sh, kv_quant, mesh)
    assert isinstance(pool_sh["kb"], ShardedTensor) and len(pool_sh["kb"].shards) == 4
    out_pool, mesh_toks = TD.pool_decode_chunk(params_sh, pool_sh, act, None, TCFG, 16,
                                               paged_kernel=True, mesh=mesh)
    np.testing.assert_array_equal(base_toks.numpy(), mesh_toks.numpy())
    np.testing.assert_allclose(out_pool["logits"].numpy(), base_pool["logits"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert isinstance(out_pool["kb"], ShardedTensor)  # the pool stays head-sharded
    # JAX's 8-device mesh on the same weights
    jmesh = _jmesh8()
    M = CACHE_LEN // BLOCK
    jpool = JD.paged_pool_init(jparams, JCFG, N_SLOTS, CACHE_LEN, n_blocks=N_SLOTS * M + 1,
                               block=BLOCK, kv_quant=kv_quant)
    jpool["block_tbl"] = jnp.asarray(_full_table())
    ids, mask = _admit_inputs()
    jpool = JD.pool_admit_batch(jparams, jnp.asarray(ids), jnp.asarray(mask), jpool,
                                jnp.arange(N_SLOTS, dtype=jnp.int32), JCFG)
    _, jtoks = JD.pool_decode_chunk(
        JD.shard_decoder_params(jparams, JCFG, jmesh), JD.shard_pool(jpool, JCFG, jmesh),
        jnp.ones((N_SLOTS,), bool), jax.random.PRNGKey(1), JCFG, 16, paged_kernel=True,
        mesh=jmesh)
    np.testing.assert_array_equal(mesh_toks.numpy(), np.asarray(jtoks))


def test_mesh8_spec_and_dense_pool_ops_match_single_device(tparams):
    """The dense int8-K/V pool, spec decode's draft and verify, and the
    prefix block moves (arena extract / insert, the host tier's export /
    import) run per shard: tokens equal the single device's, a block
    round-trips bit for bit within each arm, and the exported K agrees
    across arms within one int8 step (row-parallel sums reassociate)."""
    mesh = _mesh8()
    params_sh = TD.shard_decoder_params(tparams, TCFG, mesh)
    ids, mask = _admit_inputs()
    act = torch.ones((N_SLOTS,), dtype=torch.bool)
    out = []
    for params, m in ((tparams, None), (params_sh, mesh)):
        pool = TD.shard_pool(TD.pool_init(tparams, TCFG, N_SLOTS, 64, kv_quant=True,
                                          arena_blocks=4, arena_block=8), TCFG, m)
        pool = TD.pool_admit_batch(params, torch.from_numpy(ids), torch.from_numpy(mask),
                                   pool, torch.arange(N_SLOTS), TCFG, mesh=m)
        pool, toks, emit = TD.pool_decode_spec(params, pool, act, TCFG, 2,
                                               draft_layers=1, n_spec=3)
        pool = TD.kv_extract(pool, 1, 0, [0, 1])
        pool = TD.kv_insert(pool, 3, 16, [0, 1])
        blobs = TD.kv_block_export(pool, [0, 1])
        pool = TD.kv_block_import(pool, [2, 3], blobs)
        back = TD.kv_block_export(pool, [2, 3])
        for k in blobs:
            assert not isinstance(blobs[k], ShardedTensor)  # whole heads on the host side
            assert torch.equal(back[k], blobs[k])
        out.append((toks, emit, (blobs["k"].float() * blobs["k_scale"]).numpy()))
    (t0, e0, k0), (t1, e1, k1) = out
    assert torch.equal(t0, t1) and torch.equal(e0, e1)
    np.testing.assert_allclose(k1, k0, rtol=0, atol=float(np.abs(k0).max()) / 127 * 1.01)


def test_mesh8_forward_and_static_generate_match_single_device(tparams):
    """The whole-sequence forward (dense and causal flash) and static
    ``generate`` on sharded params: logits within 1e-5, tokens equal."""
    mesh = _mesh8()
    params_sh = TD.shard_decoder_params(tparams, TCFG, mesh)
    ids, mask = (torch.from_numpy(a) for a in _admit_inputs())
    for flash in (False, True):
        want = TD.forward(tparams, ids, mask, TCFG, flash=flash)
        got = TD.forward(params_sh, ids, mask, TCFG, flash=flash)
        live = mask.bool()
        np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TD.generate(params_sh, ids, mask, TCFG, 12).numpy(),
                                  TD.generate(tparams, ids, mask, TCFG, 12).numpy())


def test_mesh8_pool_device_bytes_cover_all_positions(tparams):
    pool = TD.paged_pool_init(tparams, TCFG, N_SLOTS, CACHE_LEN,
                              n_blocks=N_SLOTS * (CACHE_LEN // BLOCK) + 1, block=BLOCK)
    total = TD.pool_component_bytes(pool)["kv_blocks"]
    pool = TD.shard_pool(pool, TCFG, _mesh8())
    per_pos = TD.pool_component_device_bytes(pool)
    assert set(per_pos["kv_blocks"]) == {str(i) for i in range(8)}
    assert all(n == total // 4 for n in per_pos["kv_blocks"].values())
    # the replicated block table charges every position in full
    tbl = pool["block_tbl"].numel() * 4
    assert set(per_pos["block_table"].values()) == {tbl}
    assert TD.pool_component_bytes(pool)["kv_blocks"] == total


# -- mesh8 continuous serving -------------------------------------------------


def test_mesh8_serving_tokens_match_single_device(tparams):
    kw = dict(paged_kv=True, paged_kernel=True)
    baseline, _ = _serve(tparams, PROMPTS, **kw)
    probes.reset_hbm_stats()
    on_mesh, srv = _serve(tparams, PROMPTS, mesh=_mesh8(), **kw)
    assert on_mesh == baseline
    assert isinstance(srv.params["wte"], ShardedTensor)
    rebuilt = srv._build_pool()  # a supervised rebuild re-shards the same way
    assert isinstance(rebuilt["kb"], ShardedTensor) and len(rebuilt["kb"].shards) == 4


def test_mesh8_serving_records_per_position_hbm(tparams):
    probes.reset_hbm_stats()
    chat = DecoderChat(params=tparams, cfg=TCFG, tokenizer=ToyCharTokenizer(96),
                       max_new_tokens=4, max_prompt_tokens=96, continuous=True,
                       n_slots=4, chunk_steps=4, paged_kv=True, device="cpu",
                       mesh=_mesh8())
    try:
        per_dev = probes.hbm_stats()["per_device_bytes"]
        assert set(per_dev) >= {str(i) for i in range(8)}
        assert all(v > 0 for v in per_dev.values())
    finally:
        chat.close()


def test_mesh8_dense_prefix_serving_matches_single_device(tparams):
    """Shared prompts hit the dense pool's prefix arena on the mesh."""
    shared = "a shared system prompt of some length: "
    prompts = [shared + s for s in ("one", "two", "three", "four")]
    kw = dict(paged_kv=False, prefix_cache=True)
    baseline, _ = _serve(tparams, prompts, **kw)
    on_mesh, srv = _serve(tparams, prompts, mesh=_mesh8(), **kw)
    assert on_mesh == baseline
    assert srv.stats["prefix_hit_requests"] > 0


def test_mesh8_quant_serving_matches_single_device(tparams):
    base, _ = _serve(tparams, PROMPTS, weight_quant="int8")
    on_mesh, srv = _serve(tparams, PROMPTS, weight_quant="int8", mesh=_mesh8())
    assert on_mesh == base
    qkv = srv.params["layers"]["qkv_w"]
    assert isinstance(qkv, ShardedTensor) and qkv.dtype == torch.int8
    assert len({id(s) for s in qkv.shards}) == 8  # fsdp x tp pieces
    assert set(TD.params_device_bytes(srv.params)) >= {str(i) for i in range(8)}


# -- the encoder ------------------------------------------------------------------

JENC = dataclasses.replace(JT.MINILM_L6, vocab_size=128, hidden=32, layers=2, heads=4,
                           intermediate=64, max_position=64, dtype=jnp.float32)
TENC = TT.TransformerConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                            max_position=64, dtype=torch.float32)


def test_mesh8_quant_encoder_matches_host():
    """Sharded int8 encoder params (word_scale included) encode the host
    outputs (rtol = atol = 1e-5, JAX's bar)."""
    params = from_jax_params(jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(7), JENC)))
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(1, 97, (2, 16)).astype(np.int32))
    mask = torch.ones((2, 16), dtype=torch.int32)
    for p in (params, TT.quantize_encoder_params(params)):
        sharded = TT.shard_encoder_params(p, TENC, _mesh8())
        assert isinstance(sharded["embeddings"]["word"], ShardedTensor)
        np.testing.assert_allclose(TT.encode(sharded, ids, mask, TENC).numpy(),
                                   TT.encode(p, ids, mask, TENC).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_encoder_specs_lenient_like_jax():
    """A dim the tp axis does not divide replicates (lenient placement)."""
    params = TT.init_params(0, dataclasses.replace(TENC, vocab_size=30))
    sharded = TT.shard_encoder_params(params, TENC, _mesh8())
    assert tuple(sharded["embeddings"]["word"].spec) == ("fsdp", None)  # no tp
    with pytest.raises(MeshShapeError):
        TT.validate_encoder_mesh(dataclasses.replace(TENC, vocab_size=30), _mesh8())


def test_embedder_mesh_argument_matches_host_embeddings():
    from pathway_tpu_torch.models import HashTokenizer, SentenceEmbedderModel

    params = TT.init_params(3, TENC)
    texts = ["alpha beta", "gamma delta epsilon"]
    kw = dict(cfg=TENC, params=params, device="cpu",
              tokenizer=HashTokenizer(vocab_size=TENC.vocab_size, max_length=16))
    host = SentenceEmbedderModel(**kw)
    meshed = SentenceEmbedderModel(mesh=_mesh8(), **kw)
    assert isinstance(meshed.params["layers"]["qkv_w"], ShardedTensor)
    np.testing.assert_allclose(meshed.embed_batch(texts), host.embed_batch(texts),
                               rtol=1e-5, atol=1e-5)


# -- retrieval through the sharded index ----------------------------------------


def test_query_server_retrieval_hits_sharded_index():
    from pathway_tpu_torch.engine.probes import (
        reset_retrieval_backend_stats,
        retrieval_backend_stats,
    )
    from pathway_tpu_torch.models import SentenceEmbedderModel
    from pathway_tpu_torch.ops.fused_query import FusedRAGPipeline
    from pathway_tpu_torch.ops.query_server import QueryServer
    from pathway_tpu_torch.parallel import ShardedIvfIndex, make_mesh

    reset_retrieval_backend_stats()
    emb = SentenceEmbedderModel(max_length=32, device="cpu")
    assert FusedRAGPipeline(emb, None, reserved_space=16, doc_seq=16,
                            pair_seq=64).sharded_index is None
    pipe = FusedRAGPipeline(emb, None, reserved_space=16, doc_seq=16, pair_seq=64,
                            mesh_retrieval=make_mesh([CPU] * 8))
    assert isinstance(pipe.sharded_index, ShardedIvfIndex) and pipe.sharded_index.dp == 8
    words = ["alpha", "beta", "gamma", "delta", "stream", "tensor"]
    rng = np.random.default_rng(3)
    docs = [" ".join(rng.choice(words, 8)) for _ in range(12)]
    pipe.add([f"d{i}" for i in range(len(docs))], docs)
    assert len(pipe.sharded_index) == len(docs)
    server = QueryServer(pipe)
    try:
        hits = server.query("alpha stream tensor", 3)
    finally:
        server.shutdown()
    qv = pipe.embedder.embed_batch(["alpha stream tensor"])
    (dense,) = pipe.index.search(qv, k=3)
    assert [k for k, _ in hits] == [k for k, _ in dense]
    assert retrieval_backend_stats().get("sharded_ivf", 0) >= 1
    pipe.remove(["d0"])
    assert len(pipe.sharded_index) == len(docs) - 1
    one = FusedRAGPipeline(emb, None, reserved_space=16, doc_seq=16, pair_seq=64,
                           mesh_retrieval=True)  # the embedder's device on the CPU
    assert one.sharded_index.dp == 1
