"""The port's pipeline-parallel encoder and expert-parallel MoE block
against the JAX package's (``tests/test_pipeline_moe.py``), on the same
weights (``params.from_jax_params``) and inputs. The port's meshes are
virtual CPU positions; JAX's run on the conftest's 8 host devices.

Tolerances: the pipelined encode within 1e-4 of the sequential encode and
of JAX's pipelined encode (JAX's own bar); the MoE block within 1e-5 of
JAX's unsharded and ep-sharded block (f32, other summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

from pathway_tpu.models import MINILM_L6, init_params
from pathway_tpu.models import moe as JMOE
from pathway_tpu.models.pipeline import encode_pipelined as j_encode_pipelined
from pathway_tpu.models.transformer import encode as j_encode
from pathway_tpu_torch.models import moe as TMOE
from pathway_tpu_torch.models import transformer as TT
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.pipeline import encode_pipelined
from pathway_tpu_torch.parallel.mesh import Mesh, ShardedTensor, place_pytree

CPU = torch.device("cpu")


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(MINILM_L6, layers=4, hidden=32, heads=4, intermediate=64,
                               vocab_size=128, max_position=16, dtype=jnp.float32)
    tcfg = TT.TransformerConfig(layers=4, hidden=32, heads=4, intermediate=64,
                                vocab_size=128, max_position=16, dtype=torch.float32)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 128)
    mask = jnp.concatenate([jnp.ones((4, 12), jnp.int32), jnp.zeros((4, 4), jnp.int32)],
                           axis=1)
    return jcfg, tcfg, params, ids, mask


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 4), (2, 4)])
def test_pipeline_matches_sequential_and_jax(tiny, pp, n_micro):
    jcfg, tcfg, params, ids, mask = tiny
    want = np.asarray(j_encode_pipelined(
        params, ids, mask, jcfg, JMesh(np.array(jax.devices()[:pp]), ("pp",)),
        n_microbatches=n_micro))
    ref = np.asarray(j_encode(params, ids, mask, jcfg))
    tids, tmask = torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(mask))
    tp = _port(params)
    got = encode_pipelined(tp, tids, tmask, tcfg, Mesh([CPU] * pp, (pp,), ("pp",)),
                           n_microbatches=n_micro).numpy()
    seq = TT.encode(tp, tids, tmask, tcfg).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - seq).max() < 1e-4
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(got - want).max() < 1e-4


def test_pipeline_validates_divisibility(tiny):
    _, tcfg, params, ids, mask = tiny
    tids, tmask = torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(mask))
    tp = _port(params)
    with pytest.raises(ValueError, match="divide"):
        encode_pipelined(tp, tids, tmask, tcfg, Mesh([CPU] * 3, (3,), ("pp",)),
                         n_microbatches=2)
    with pytest.raises(ValueError, match="divide"):
        encode_pipelined(tp, tids, tmask, tcfg, Mesh([CPU] * 2, (2,), ("pp",)),
                         n_microbatches=3)


def test_moe_shapes_routing_and_aux_match_jax(tiny):
    jcfg, tcfg, _, _, _ = tiny
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 16, jcfg.hidden))
    tx = torch.from_numpy(np.array(x))
    for cap in (2.0, 0.25):  # the tight capacity drops tokens (zero rows)
        jmoe = JMOE.MoEConfig(n_experts=4, capacity_factor=cap)
        tmoe = TMOE.MoEConfig(n_experts=4, capacity_factor=cap)
        mp = JMOE.init_moe_params(jax.random.PRNGKey(2), jcfg, jmoe)
        want, want_aux = JMOE.moe_ffn(x, mp, jcfg, jmoe)
        got, aux = TMOE.moe_ffn(tx, _port(mp), tcfg, tmoe)
        assert got.shape == tx.shape and float(aux) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
        np.testing.assert_array_equal(np.all(got.numpy() == 0, axis=-1),
                                      np.all(np.asarray(want) == 0, axis=-1))
    own = TMOE.init_moe_params(0, tcfg, tmoe)  # the port's own seeded weights
    assert own["expert_in_w"].shape == (4, tcfg.hidden, tcfg.intermediate)


def test_moe_ep_sharded_matches_unsharded_and_jax(tiny):
    jcfg, tcfg, _, _, _ = tiny
    jmoe = JMOE.MoEConfig(n_experts=8, capacity_factor=2.0)
    tmoe = TMOE.MoEConfig(n_experts=8, capacity_factor=2.0)
    mp = JMOE.init_moe_params(jax.random.PRNGKey(4), jcfg, jmoe)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 16, jcfg.hidden))
    ref, _ = JMOE.moe_ffn(x, mp, jcfg, jmoe)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("ep",))
    specs = JMOE.moe_partition_specs(jmoe)
    mp_sh = {k: jax.device_put(v, NamedSharding(jmesh, specs[k])) for k, v in mp.items()}
    with jmesh:
        want, _ = jax.jit(lambda x, mp: JMOE.moe_ffn(x, mp, jcfg, jmoe))(x, mp_sh)
    tx = torch.from_numpy(np.array(x))
    placed = place_pytree(_port(mp), Mesh([CPU] * 8, (8,), ("ep",)),
                          TMOE.moe_partition_specs(tmoe))
    assert isinstance(placed["expert_in_w"], ShardedTensor)
    assert len(placed["expert_in_w"].shards) == 8
    got, _ = TMOE.moe_ffn(tx, placed, tcfg, tmoe)
    plain, _ = TMOE.moe_ffn(tx, _port(mp), tcfg, tmoe)
    assert np.abs(got.numpy() - plain.numpy()).max() < 1e-5
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
