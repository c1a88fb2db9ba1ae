"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: skipped where no CUDA device is present. Imports
neither JAX nor the JAX package, so the file also runs on a machine
with only PyTorch. Run there with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances. The attention kernels keep scores and probabilities in f32
and differ from the dense f32 plain versions only in summation order and
in their fast exp: atol 1e-4 for f32 inputs, 2e-3 for bf16 or int8 inputs
(larger values). ``paged_attn_decode`` returns q's dtype: bf16 outputs may
round to the neighbouring bf16 value, so rtol 2**-7 (one bf16 ulp) and atol
1e-3. ``wq_matmul`` sums exact products in f32 in another order than the
f32 cuBLAS product of the plain version: rtol 1e-5, atol 1e-5 of the
largest output.
"""

import pytest
import torch

from pathway_tpu_torch.models import flash_attention as TFA
from pathway_tpu_torch.models import paged_attention as TPA
from pathway_tpu_torch.models import wq_matmul as TWQ


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("b,nh,seq,hd", [(5, 3, 37, 32), (2, 2, 160, 64), (2, 1, 70, 128),
                                         (3, 2, 5, 8), (4, 3, 24, 32), (3, 5, 16, 64),
                                         (5, 3, 12, 128)])
def test_flash_attn_kernel_matches_plain_version(cuda, b, nh, seq, hd, dtype, atol, causal):
    g = torch.Generator(device="cpu").manual_seed(seq + hd)
    q, k, v = (torch.randn((b, nh, seq, hd), generator=g).to(cuda, dtype) for _ in range(3))
    lens = torch.tensor([seq, max(seq // 2, 1), 0, 1, 3][:b], dtype=torch.int32)
    mask = (torch.arange(seq)[None, :] < lens[:, None]).to(torch.int32).to(cuda)
    before = TFA.flash_attn.launches
    out = TFA.flash_attn(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert TFA.flash_attn.launches == before + 1
    ref = TFA.flash_attn_reference(q, k, v, mask, causal=causal)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    dead = lens.to(cuda) == 0
    assert torch.all(out[dead] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("seq", [1, 16, 21, 32, 160, 512])
def test_flash_attn_mma_design_edges(cuda, seq, hd, dtype, atol, causal):
    """The bf16 design's edges: every key-tile width (S <= 16, <= 32, more),
    groups of 4 or 2 heads that cross batch rows (nh = 3), 64-row query
    chunks past S = 64, left-padded masks (the decoder's admission) and an
    all-masked row; more groups than persistent blocks at S = 16."""
    b, nh = (2000, 3) if seq == 16 else (3, 3)
    g = torch.Generator(device="cpu").manual_seed(seq * 7 + hd)
    q, k, v = (torch.randn((b, nh, seq, hd), generator=g).to(cuda, dtype) for _ in range(3))
    lens = torch.randint(1, seq + 1, (b,), generator=g)
    lens[0], lens[1] = 0, seq
    mask = (torch.arange(seq)[None, :] >= (seq - lens)[:, None]).to(torch.int32).to(cuda)
    out = TFA.flash_attn(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    ref = TFA.flash_attn_reference(q, k, v, mask, causal=causal)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    assert torch.all(out[0] == 0)


@pytest.mark.cuda
def test_flash_attn_kernel_refuses_bad_inputs(cuda):
    q = torch.zeros((1, 1, 8, 12), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TFA.flash_attn(q, q, q, mask)
    q = torch.zeros((1, 1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        TFA.flash_attn(q, q, q, mask.long())
    with pytest.raises(ValueError, match="contiguous"):
        TFA.flash_attn(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, mask)


def _paged_case(g, B, nh, hd, Bk, M, quant, dtype, dev):
    """Shuffled physical blocks, ragged masks, an empty slot (0), a slot
    whose table tail is the sentinel (1), block 0 zero."""
    n_blocks = B * M + 1
    q = torch.randn((B, nh, hd), generator=g).to(dev, dtype)
    if quant:
        kb, vb = (torch.randint(-127, 128, (n_blocks, nh, Bk, hd), generator=g,
                                dtype=torch.int8).to(dev) for _ in range(2))
        kbs, vbs = (torch.empty((n_blocks, nh, Bk, 1)).uniform_(0.01, 0.05, generator=g).to(dev)
                    for _ in range(2))
    else:
        kb, vb = (torch.randn((n_blocks, nh, Bk, hd), generator=g).to(dev, dtype)
                  for _ in range(2))
        kbs = vbs = None
    for t in (kb, vb, kbs, vbs):
        if t is not None:
            t[0] = 0
    tbl = (torch.randperm(n_blocks - 1, generator=g)[: B * M] + 1).reshape(B, M)
    lens = torch.randint(1, M * Bk + 1, (B,), generator=g)
    lens[0] = 0
    if B > 1:
        lens[1] = min(Bk + 3, M * Bk)
        tbl[1, (lens[1] + Bk - 1) // Bk:] = 0
    mask = (torch.arange(M * Bk)[None, :] < lens[:, None]).to(torch.int32)
    return (q, kb, vb, kbs, vbs, tbl.to(torch.int32).to(dev), mask.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nh,hd,Bk,M", [(16, 12, 64, 64, 11), (3, 2, 8, 8, 3),
                                          (4, 3, 128, 16, 5), (5, 1, 32, 64, 2),
                                          (2, 2, 256, 8, 4)])
def test_paged_attn_kernel_matches_plain_version(cuda, B, nh, hd, Bk, M, quant, dtype):
    g = torch.Generator().manual_seed(B * 100 + hd + Bk)
    args = _paged_case(g, B, nh, hd, Bk, M, quant, dtype, cuda)
    before = TPA.paged_attn_decode.launches
    out = TPA.paged_attn_decode(*args)
    torch.cuda.synchronize()
    assert TPA.paged_attn_decode.launches == before + 1
    ref = TPA.paged_attn_decode_reference(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    assert torch.all(out[0] == 0)  # the empty slot
    for t in args[1:5]:
        if t is not None:
            assert torch.all(t[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [5, 8, 20, 64, 128, 256])
@pytest.mark.parametrize("Bk", [8, 16, 32, 64])
def test_paged_attn_split_design_edges(cuda, Bk, hd, dtype, quant):
    """The bf16 design's edges at every block size and head_dim (5: rows
    of an odd byte count, 20: of 8-byte copies): slot 0 empty (every split
    dead), slot 1 one live column in its last block,
    slot 2 a non-prefix mask with a sentinel tail, slot 3 full; every
    split plan (one to eight splits a cluster) agrees with the plain version, and
    two runs are equal (splits meet in a fixed order). f32 queries take the
    earlier design and are held to the plain version as well."""
    B, nh, M = 4, 3, 6
    g = torch.Generator().manual_seed(Bk * 1000 + hd + quant)
    q, kb, vb, kbs, vbs, tbl, mask = _paged_case(g, B, nh, hd, Bk, M, quant, dtype, cuda)
    mask = mask.cpu()
    tbl = tbl.cpu()
    mask[0] = 0
    mask[1] = 0
    mask[1, M * Bk - 1] = 1
    mask[2] = (torch.rand(M * Bk, generator=g) < 0.4).to(torch.int32)
    mask[2, (M - 2) * Bk:] = 0
    tbl[2, M - 2:] = 0
    mask[3] = 1
    args = (q, kb, vb, kbs, vbs, tbl.to(cuda), mask.to(cuda))
    ref = TPA.paged_attn_decode_reference(*args)

    def check(out):
        assert out.dtype == dtype and out.shape == ref.shape
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
        else:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
        assert torch.all(out[0] == 0)

    out = TPA.paged_attn_decode(*args)
    again = TPA.paged_attn_decode(*args)
    torch.cuda.synchronize()
    check(out)
    assert torch.equal(out, again)
    if dtype == torch.bfloat16:
        for cols in TPA.SPLIT_CANDIDATES + (Bk, 2 * Bk):  # (Bk: a split an entry)
            o = torch.empty_like(q)
            TPA._launch(*args, o, hd ** -0.5, split_cols=cols)
            torch.cuda.synchronize()
            check(o)


def _chunk_case(g, nh, T, C, hd, quant, dtype, dev, start):
    q = torch.randn((nh, T, hd), generator=g).to(dev, dtype)
    if quant:
        k, v = (torch.randint(-127, 128, (nh, C, hd), generator=g, dtype=torch.int8).to(dev)
                for _ in range(2))
        ks, vs = (torch.empty((nh, C, 1)).uniform_(0.01, 0.05, generator=g).to(dev)
                  for _ in range(2))
    else:
        k, v = (torch.randn((nh, C, hd), generator=g).to(dev, dtype) for _ in range(2))
        ks = vs = None
    row_mask = (torch.arange(C) < start + T).to(torch.int32)
    row_mask[3::7] = 0  # holes
    return q, k, v, ks, vs, row_mask.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,T,C,hd,Bk,start", [(12, 64, 704, 64, 64, 0),
                                                (12, 64, 704, 64, 64, 64),
                                                (12, 64, 704, 64, 64, 640),
                                                (4, 8, 96, 8, 16, 7),
                                                (3, 5, 48, 128, 8, 40),
                                                (2, 40, 64, 32, 32, 0)])
def test_flash_chunk_kernels_match_plain_version(cuda, nh, T, C, hd, Bk, start, quant, dtype):
    g = torch.Generator().manual_seed(C + start + hd)
    q, k, v, ks, vs, row_mask = _chunk_case(g, nh, T, C, hd, quant, dtype, cuda, start)
    atol = 1e-4 if dtype == torch.float32 and not quant else 2e-3
    before = TFA.flash_chunk_attn.launches
    out = TFA.flash_chunk_attn(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert TFA.flash_chunk_attn.launches == before + 1
    ref = TFA.flash_chunk_attn_reference(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    # the same cache cut into shuffled physical blocks behind a table row
    M = C // Bk
    n_blocks = M + 3
    perm = (torch.randperm(n_blocks - 1, generator=g)[:M] + 1).to(cuda)

    def planes(row):
        if row is None:
            return None
        pl = torch.zeros((n_blocks, nh, Bk, row.shape[-1]), dtype=row.dtype, device=cuda)
        pl[perm.long()] = row.reshape(nh, M, Bk, -1).transpose(0, 1)
        return pl

    kb, vb, kbs, vbs = (planes(t) for t in (k, v, ks, vs))
    tbl = perm.to(torch.int32)
    before = TFA.flash_chunk_attn_paged.launches
    paged = TFA.flash_chunk_attn_paged(q, kb, vb, kbs, vbs, tbl, row_mask, start)
    torch.cuda.synchronize()
    assert TFA.flash_chunk_attn_paged.launches == before + 1
    assert torch.equal(paged, out)  # same arithmetic, other addressing


def _to_planes(row, perm, n_blocks, Bk, dev):
    """A dense (heads, C, d) row as shuffled physical blocks of Bk columns
    at the ids ``perm``; other blocks stay zero."""
    if row is None:
        return None
    nh, C, d = row.shape
    pl = torch.zeros((n_blocks, nh, Bk, d), dtype=row.dtype, device=dev)
    pl[perm.long()] = row.reshape(nh, C // Bk, Bk, d).transpose(0, 1)
    return pl


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nh,T,C,hd,Bk,start,dead_to", [
    (2, 5, 128, 8, 16, 45, 0),       # start off the split grid, last split partly dead
    (3, 40, 192, 128, 64, 77, 0),    # T = 40, head_dim 128
    (2, 16, 128, 64, 16, 20, 24),    # rows 0-3 have no live column
    (12, 64, 704, 64, 64, 448, 0),   # the main-path piece
    (2, 8, 4096, 64, 64, 4000, 0),   # more splits than a combine holds: wider splits
    (2, 70, 256, 40, 16, 100, 0),    # two query tiles, head_dim 40
    (1, 4, 20032, 64, 64, 19990, 0),  # splits wider than one staged window
])
def test_flash_chunk_split_design_edges(cuda, nh, T, C, hd, Bk, start, dead_to, quant):
    """The bf16 design's edges: split and query-tile boundaries, dead rows,
    padded head_dim; paged equal to dense bit for bit at the same split
    boundaries; two runs equal (the combine adds splits in a fixed order)."""
    g = torch.Generator().manual_seed(C + start + hd + T)
    q, k, v, ks, vs, row_mask = _chunk_case(g, nh, T, C, hd, quant, torch.bfloat16, cuda, start)
    row_mask[:dead_to] = 0
    plan = TFA.chunk_plan(nh, T, C, start, hd)
    assert plan.n_splits <= TFA.MAX_SPLITS
    out = TFA.flash_chunk_attn(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    again = TFA.flash_chunk_attn(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = TFA.flash_chunk_attn_reference(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    assert torch.equal(out, again)
    dead = start + torch.arange(T) < dead_to
    assert torch.all(out[:, dead.to(cuda)] == 0)
    M = C // Bk
    perm = (torch.randperm(M + 2, generator=g)[:M] + 1).to(cuda)
    kb, vb, kbs, vbs = (_to_planes(t, perm, M + 3, Bk, cuda) for t in (k, v, ks, vs))
    paged = TFA.flash_chunk_attn_paged(q, kb, vb, kbs, vbs, perm.to(torch.int32), row_mask, start)
    torch.cuda.synchronize()
    assert torch.equal(paged, out)


@pytest.mark.cuda
@pytest.mark.parametrize("split_cols", TFA.SPLIT_CANDIDATES + (96,))
@pytest.mark.parametrize("nh,T,C,start", [(12, 64, 704, 448), (2, 70, 256, 100)])
def test_flash_chunk_split_widths_agree(cuda, nh, T, C, start, split_cols):
    """Every split width computes the same function."""
    g = torch.Generator().manual_seed(split_cols + T)
    q, k, v, ks, vs, row_mask = _chunk_case(g, nh, T, C, 64, True, torch.bfloat16, cuda, start)
    out = TFA._launch_chunk(q, k, v, ks, vs, None, row_mask, start, C, C, 1 / 8,
                            split_cols=split_cols)
    torch.cuda.synchronize()
    ref = TFA.flash_chunk_attn_reference(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 64, 200])
@pytest.mark.parametrize("K,N", [(768, 2304), (768, 768), (768, 3072), (3072, 768),
                                 (100, 27), (64, 130)])
def test_wq_matmul_kernel_matches_plain_version(cuda, M, K, N, dtype):
    g = torch.Generator().manual_seed(M * 7 + K + N)
    x = torch.randn((M, K), generator=g).to(cuda, dtype)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(cuda)
    s = torch.empty((1, N)).uniform_(1e-4, 1e-2, generator=g).to(cuda)
    before = TWQ.wq_matmul.launches
    out = TWQ.wq_matmul(x, w, s)
    torch.cuda.synchronize()
    assert TWQ.wq_matmul.launches == before + 1
    ref = TWQ.wq_matmul_reference(x, w, s)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("M", [1, 16, 64, 65, 200])
@pytest.mark.parametrize("K,N", [(100, 2309), (3072, 2309), (3072, 768)])
def test_wq_matmul_mma_design_edges(cuda, M, K, N, misaligned):
    """The bf16 design's edges: split K with a ragged last step (K = 100),
    row tiles past 64, a ragged N, and a weight one byte off 16-byte
    alignment (the guarded narrow loads); two runs equal (the splits'
    partial sums meet in a fixed order)."""
    g = torch.Generator().manual_seed(M * 7 + K + N + misaligned)
    x = torch.randn((M, K), generator=g).to(cuda, torch.bfloat16)
    flat = torch.randint(-127, 128, (K * N + 1,), generator=g, dtype=torch.int8).to(cuda)
    w = flat[1:].view(K, N) if misaligned else flat[:-1].view(K, N)
    assert (w.data_ptr() % 16 != 0) == misaligned
    s = torch.empty((1, N)).uniform_(1e-4, 1e-2, generator=g).to(cuda)
    out = TWQ.wq_matmul(x, w, s)
    again = TWQ.wq_matmul(x, w, s)
    torch.cuda.synchronize()
    ref = TWQ.wq_matmul_reference(x, w, s)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_new_kernels_refuse_bad_inputs(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError, match="int8"):
        TWQ.wq_matmul(x, torch.zeros((8, 4), device=cuda), torch.ones(4, device=cuda))
    q = torch.zeros((2, 2, 8), device=cuda)
    kb = torch.zeros((3, 2, 8, 8), device=cuda, dtype=torch.int8)
    tbl = torch.ones((2, 1), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        TPA.paged_attn_decode(q, kb, kb, None, None, tbl, mask)
    qc = torch.zeros((2, 4, 12), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TFA.flash_chunk_attn(qc, torch.zeros((2, 16, 12), device=cuda),
                             torch.zeros((2, 16, 12), device=cuda),
                             torch.ones(16, dtype=torch.int32, device=cuda), 0)
