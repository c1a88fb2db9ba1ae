"""Mixture-of-Experts FFN with expert parallelism: Switch-style top-1
routing with capacity (counterpart of ``pathway_tpu/models/moe.py``).

Experts are stacked on a leading axis, so the block is three products
(dispatch, expert FFN, combine). Placed on a mesh with an ``ep`` axis
(:func:`moe_partition_specs`, ``parallel.place_pytree``) each shard
stores ``E / ep`` experts; the block then runs each shard's experts on
their own device over the tokens dispatched to them, and the shards'
combined outputs are summed in a fixed order, shard 0 first. Torch ops:
JAX's block is XLA einsums, no Pallas.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pathway_tpu_torch.models.transformer import TransformerConfig, _normal
from pathway_tpu_torch.parallel.mesh import P, ShardedTensor, all_reduce_sum, axis_shards

EP_AXIS = "ep"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def init_moe_params(seed: int, cfg: TransformerConfig, moe: MoEConfig) -> dict:
    """Router and stacked expert FFN weights, experts on the leading (ep)
    axis, drawn from a seeded CPU generator (JAX's PRNG differs: tests
    share weights through ``params.from_jax_params``)."""
    gen = torch.Generator().manual_seed(int(seed))
    h, f, e = cfg.hidden, cfg.intermediate, moe.n_experts
    return {
        "router_w": _normal(gen, (h, e), torch.float32),
        "expert_in_w": _normal(gen, (e, h, f), torch.float32),
        "expert_in_b": torch.zeros((e, f)),
        "expert_out_w": _normal(gen, (e, f, h), torch.float32),
        "expert_out_b": torch.zeros((e, h)),
    }


def moe_partition_specs(moe: MoEConfig, ep_axis: str = EP_AXIS) -> dict:
    return {
        "router_w": P(None, None),
        "expert_in_w": P(ep_axis, None, None),
        "expert_in_b": P(ep_axis, None),
        "expert_out_w": P(ep_axis, None, None),
        "expert_out_b": P(ep_axis, None),
    }


def _experts(xs, w_in, b_in, w_out, b_out):
    """(E, C, H) dispatched blocks through their experts' FFNs."""
    hdn = F.gelu(torch.einsum("ech,ehf->ecf", xs, w_in) + b_in[:, None, :],
                 approximate="tanh")
    return torch.einsum("ecf,efh->ech", hdn, w_out) + b_out[:, None, :]


def moe_ffn(x, mp: dict, cfg: TransformerConfig, moe: MoEConfig):
    """Top-1 routed MoE FFN. x: (B, S, H). Returns ``(y (B, S, H) f32,
    aux_loss)``: each token through its top-1 expert scaled by its gate
    (tokens past an expert's capacity come out as zeros), and the Switch
    load-balancing loss."""
    B, S, H = x.shape
    T, E = B * S, moe.n_experts
    C = max(1, int(moe.capacity_factor * T / E))
    tokens = x.reshape(T, H).float()
    router = mp["router_w"]
    if isinstance(router, ShardedTensor):
        router = router.gather()
    probs = torch.softmax(tokens @ router.to(tokens.device), dim=-1)  # (T, E)
    gate, expert = probs.max(dim=-1)
    # each token's place in its expert's queue, first come first served
    one_hot = F.one_hot(expert, E).float()
    pos = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1.0
    keep = pos < C
    gate = gate * keep
    slot = F.one_hot(pos.long().clamp(0, C - 1), C).float() * keep[:, None]
    dispatch = one_hot[:, :, None] * slot[:, None, :]  # (T, E, C)
    combine = dispatch * gate[:, None, None]
    names = ("expert_in_w", "expert_in_b", "expert_out_w", "expert_out_b")
    if isinstance(mp["expert_in_w"], ShardedTensor):
        shards = list(zip(*(axis_shards(mp[n], EP_AXIS) for n in names)))
        e_loc = E // len(shards)
        parts = []
        for s, ws in enumerate(shards):
            dev = ws[0].device
            sel = slice(s * e_loc, (s + 1) * e_loc)
            xs = torch.einsum("tec,th->ech", dispatch[:, sel].to(dev), tokens.to(dev))
            parts.append(torch.einsum("tec,ech->th", combine[:, sel].to(dev), _experts(xs, *ws)))
        y = all_reduce_sum(parts).to(x.device)
    else:
        xs = torch.einsum("tec,th->ech", dispatch, tokens)
        y = torch.einsum("tec,ech->th", combine, _experts(xs, *(mp[n] for n in names)))
    aux = E * (one_hot.mean(dim=0) * probs.mean(dim=0)).sum() * moe.router_aux_weight
    return y.reshape(B, S, H), aux
