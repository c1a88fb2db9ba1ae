"""Ingest-time compressed late-interaction doc-token bank (counterpart of
``pathway_tpu/ops/late_bank.py``).

The rerank cascade's cheap stage re-encodes every (query, doc) pair
through the first layers of the cross-encoder at query time. The bank
moves that cost to ingest: each document is encoded once, through the
full encoder, when it enters the index; its token states are projected to
a small ``dc``-dim space, unit-normalised and stored int8 with one f32
scale a token, on the device beside the corpus. The cheap stage becomes
late-interaction MaxSim over the gathered bank rows:

    maxsim(q, d) = sum_s  max_t  <q_s, d_t>          (unit vectors)

one (S, dc) x (dc, T) product a candidate. At ``dc`` = 32 a bank token
costs ``dc + 4`` bytes; the ``late_bank`` HBM component tracks the live
footprint.

These are the pieces shared by ``ops/fused_query.py`` (the MaxSim cascade
and the bank's lifecycle) and ``models/embedder.py`` (the token-level
ingest path). JAX leaves them to XLA, so here they are plain torch ops.
One deliberate difference: :func:`late_projection` draws its matrix from a
seeded ``torch.Generator``, not ``jax.random.normal``, so its values are
the port's own; callers that need JAX's matrix pass it in (``late_proj=``).
"""

from __future__ import annotations

import math

import torch

from pathway_tpu_torch.models.transformer import TransformerConfig, encode

# symmetric int8 quantization constants, the KV-quant contract: |x| / scale
# <= 127 by construction, all-zero rows (padding) quantize to exact zeros
# through the scale floor
_LATE_QMAX = 127.0
_LATE_SCALE_FLOOR = 1e-8
# the compressed token width by default (JAX's PATHWAY_TPU_LATE_DIM)
LATE_DIM = 32


def late_projection(hidden: int, dc: int, seed: int = 0) -> torch.Tensor:
    """A fixed ``(hidden, dc)`` f32 down-projection (on the CPU): seeded
    normal entries at scale 1/sqrt(hidden), the same matrix at ingest and
    at query time with no checkpoint to version. Random projections keep
    inner products approximately (Johnson-Lindenstrauss), which is all
    MaxSim reads."""
    gen = torch.Generator().manual_seed(int(seed))
    w = torch.randn((int(hidden), int(dc)), generator=gen, dtype=torch.float32)
    return w / math.sqrt(hidden)


def _project_tokens(hidden, mask, proj):
    """(B, S, H) token states -> (B, S, dc) unit vectors, padding zeroed."""
    t = hidden.float() @ proj.float()
    t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    return t * mask.float()[:, :, None]


def _quant_tokens(t):
    """Per-token symmetric int8 over the dc axis: ``(payload int8, scale
    f32 (..., 1))`` with ``t ~= payload * scale``."""
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / _LATE_QMAX, min=_LATE_SCALE_FLOOR)
    return torch.round(t / scale).to(torch.int8), scale


def doc_token_states(params, input_ids, attention_mask, proj,
                     cfg: TransformerConfig):
    """Full-depth encode -> project -> normalise -> int8 quant. Returns
    ``(payload int8 (B, S, dc), scale f32 (B, S, 1))``: the bank rows of a
    batch of documents, computed once a document."""
    hidden = encode(params, input_ids, attention_mask, cfg)
    return _quant_tokens(_project_tokens(hidden, attention_mask, proj))


def query_token_states(hidden, q_mask, proj):
    """Query-side (B, S, dc) unit token states from encoder states already
    computed: the cascade encodes a query once and feeds both the pooled
    retrieval embedding and this projection."""
    return _project_tokens(hidden, q_mask, proj)


def maxsim_scores(q_tok, q_mask, bank_q, bank_scale, d_lens):
    """Late-interaction MaxSim ``sum_s max_t <q_s, d_t>``.

    q_tok (Qb, S, dc) unit query tokens (padding rows zero), q_mask (Qb,
    S), bank_q int8 (Qb, k, T, dc) and bank_scale (Qb, k, T, 1) the
    gathered candidate rows, d_lens (Qb, k) live doc-token counts. Returns
    (Qb, k) f32. Doc positions >= d_lens drop out of the max through a
    -1e9 fill, not -inf: a zero-length doc scores a finite, very bad
    value."""
    d = bank_q.float() * bank_scale                              # (Qb,k,T,dc)
    sim = torch.einsum("qsd,qktd->qkst", q_tok.float(), d)
    t_live = (torch.arange(d.shape[2], device=d.device)[None, None, :]
              < d_lens[:, :, None])                              # (Qb,k,T)
    sim = torch.where(t_live[:, :, None, :], sim, -1e9)
    best = sim.amax(dim=3)                                       # (Qb,k,S)
    q_live = q_mask.float()[:, None, :]                          # (Qb,1,S)
    return torch.where(q_live > 0, best, 0.0).sum(dim=2)


def maxsim_flops(q_seq: int, doc_seq: int, dc: int, pairs: int) -> float:
    """Model FLOPs of the MaxSim stage over ``pairs`` candidates: the
    (S, dc) x (dc, T) similarity product a pair. The per-query projection
    is charged by the caller (:func:`projection_flops`)."""
    return float(pairs) * 2.0 * q_seq * doc_seq * dc


def projection_flops(q_seq: int, hidden: int, dc: int, queries: int) -> float:
    """FLOPs of projecting ``queries`` queries' token states to dc."""
    return float(queries) * 2.0 * q_seq * hidden * dc


def bank_row_bytes(doc_seq: int, dc: int) -> int:
    """Bank bytes a document row: int8 payload + f32 scale a token."""
    return doc_seq * dc + doc_seq * 4
