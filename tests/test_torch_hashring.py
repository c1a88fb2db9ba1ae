"""The port's consistent-hash ring (``pathway_tpu_torch/serving/hashring.py``)
against the JAX package's (after tests/test_hashring.py).

The same members and keys give the same owner in both packages (blake2b
positions), ``head_block_key`` and ``affinity_block_tokens`` are equal to
JAX's, a join moves about K/N keys, all to the joiner, and a leave moves
only the leaver's keys.
"""

import numpy as np
import pytest

from pathway_tpu.serving import hashring as J
from pathway_tpu_torch.serving import hashring as T


def _keys(n=2000):
    return [f"key-{i}".encode() for i in range(n)]


def _placement(ring, keys):
    return {k: ring.lookup(k) for k in keys}


@pytest.mark.parametrize("vnodes", [1, 16, 64, 128])
@pytest.mark.parametrize("members", [1, 3, 7])
def test_lookup_equals_jax(vnodes, members):
    rng = np.random.default_rng(vnodes * 31 + members)
    jr, tr = J.HashRing(vnodes=vnodes), T.HashRing(vnodes=vnodes)
    for i in rng.permutation(members):
        assert jr.add(f"replica-{i}") == tr.add(f"replica-{i}") == vnodes
    keys = [rng.integers(0, 2 ** 31, rng.integers(1, 40)).tobytes() for _ in range(500)]
    assert [tr.lookup(k) for k in keys] == [jr.lookup(k) for k in keys]
    assert tr.members() == jr.members()
    jr.remove("replica-0")
    tr.remove("replica-0")
    assert [tr.lookup(k) for k in keys] == [jr.lookup(k) for k in keys]


def test_head_block_key_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        toks = rng.integers(0, 50257, rng.integers(0, 300)).tolist()
        block = int(rng.choice([8, 16, 64]))
        blocks = int(rng.integers(1, 6))
        assert (T.head_block_key(toks, block=block, blocks=blocks)
                == J.head_block_key(toks, block=block, blocks=blocks))


@pytest.mark.parametrize("chunk,block", [(64, 0), (8, 0), (8, 16), (16, 8), (100, 0), (3, 0)])
def test_affinity_block_tokens_equals_jax(chunk, block):
    assert (T.affinity_block_tokens(chunk, block)
            == J.affinity_block_tokens(prefill_chunk=chunk, prefix_block=block))


def test_default_affinity_block_is_the_servers_prefix_block():
    assert T.affinity_block_tokens() == 64


def test_deterministic_placement_across_instances():
    a, b, c = (T.HashRing(vnodes=64) for _ in range(3))
    for rid in ("replica-0", "replica-1", "replica-2"):
        a.add(rid)
        b.add(rid)
    for rid in ("replica-2", "replica-0", "replica-1"):
        c.add(rid)
    keys = _keys()
    assert _placement(a, keys) == _placement(b, keys) == _placement(c, keys)


def test_join_moves_at_most_k_over_n_plus_eps():
    ring = T.HashRing(vnodes=128)
    for i in range(4):
        ring.add(f"replica-{i}")
    keys = _keys(4000)
    before = _placement(ring, keys)
    ring.add("replica-4")
    after = _placement(ring, keys)
    moved = [k for k in keys if before[k] != after[k]]
    assert all(after[k] == "replica-4" for k in moved)
    expected = len(keys) / 5
    assert expected * 0.5 <= len(moved) <= expected * 1.5


def test_leave_moves_only_the_leavers_keys():
    ring = T.HashRing(vnodes=128)
    for i in range(5):
        ring.add(f"replica-{i}")
    keys = _keys(4000)
    before = _placement(ring, keys)
    ring.remove("replica-2")
    after = _placement(ring, keys)
    for k in keys:
        if before[k] == "replica-2":
            assert after[k] != "replica-2"
        else:
            assert after[k] == before[k]
    assert sum(1 for k in keys if before[k] == "replica-2") <= len(keys) / 5 * 1.5


def test_membership_bookkeeping():
    ring = T.HashRing(vnodes=16)
    assert ring.lookup(b"anything") is None
    assert ring.add("a") == 16
    assert ring.add("a") == 0
    assert "a" in ring and len(ring) == 1
    assert ring.remove("missing") == 0
    assert ring.remove("a") == 16
    assert ring.members() == [] and len(ring) == 0


def test_head_key_stable_under_suffix_edits():
    head = [7] * 32
    k1 = T.head_block_key(head + [1, 2, 3], block=8, blocks=4)
    assert k1 == T.head_block_key(head + [9] * 40, block=8, blocks=4) \
        == T.head_block_key(head, block=8, blocks=4)
    assert T.head_block_key([8] * 32 + [1, 2, 3], block=8, blocks=4) != k1
    assert T.head_block_key(head[:24] + [5] * 8 + [1, 2, 3], block=8, blocks=4) != k1
    # a prompt of fewer full blocks keys on those; under one block, on all
    assert T.head_block_key([3] * 20, block=8, blocks=4) == \
        T.head_block_key([3] * 16 + [9, 9, 9, 9], block=8, blocks=4)
    assert T.head_block_key([1, 2, 3], block=8, blocks=4) != \
        T.head_block_key([1, 2, 4], block=8, blocks=4)


def test_validation():
    with pytest.raises(ValueError):
        T.head_block_key([1], block=0, blocks=4)
    with pytest.raises(ValueError):
        T.head_block_key([1], block=8, blocks=0)
    with pytest.raises(ValueError):
        T.HashRing(vnodes=0)
