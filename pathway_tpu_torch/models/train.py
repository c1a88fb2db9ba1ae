"""Training of the embedder and the decoder (counterpart of
``pathway_tpu/models/train.py``): the contrastive (InfoNCE, in-batch
negatives) step of the encoder and the causal-LM step of the decoder,
both on AdamW.

The optimiser is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
(:class:`AdamW`, the port's ``optax.adamw(learning_rate)``): betas (0.9,
0.999), eps 1e-8 and a weight decay of 1e-4 on every leaf (torch's own
default decay is 1e-2). The forward is the
dense one JAX trains through: the encoder's :func:`~.transformer.dense_core`
(``encode(flash=False)``) and ``decoder.forward(flash=False)``, plain torch
ops with the finite ``-1e9`` biases. No kernel of the port runs in a step:
the attention kernels have no backward, as JAX's Pallas kernels have no
``custom_vjp``. Params stay in ``cfg.param_dtype`` (f32) and compute runs
in ``cfg.dtype``.

A step is a plain function ``step(state, batch) -> (state, loss)``: it
updates the params in place (the optimiser's own leaves), returns the loss
as a 0-dim tensor on the device and synchronises nothing. JAX's step is
pure and jitted; here ``state.params`` are the same tensors before and
after.

Sharded steps (JAX jits the same step with dp/tp shardings and lets GSPMD
partition it): a params tree placed on a ``(dp, tp)`` mesh
(``parallel.place_pytree``, e.g. with ``param_partition_specs``) makes the
step data parallel. Each dp replica assembles its params from its own
positions (ZeRO-3's gather on use, differentiable), computes its share of
the batch, the objective joins the shares (the in-batch negatives over the
whole batch, the LM normaliser over every replica's tokens), and after the
backward every replica of a box gets the sum of the replicas' gradients
(``parallel.reduce_replica_grads``). The optimiser's leaves are the
shards, so the moments stay sharded like their params and the replicas
stay bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models import decoder as decoder_mod
from pathway_tpu_torch.models.embedder import mean_pool
from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    encode,
    init_params,
    map_params,
)
from pathway_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ShardedTensor,
    reduce_replica_grads,
    tree_mesh,
)


class TrainState(NamedTuple):
    params: dict
    opt_state: torch.optim.Optimizer
    step: int


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` as a factory of ``torch.optim.AdamW``: ``init``
    builds the optimiser over a params tree (JAX's ``tx.init``)."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> torch.optim.AdamW:
        """The optimiser over every leaf of ``params``: the plain tensors
        and, of a sharded leaf, its distinct shards. Each becomes a leaf
        that requires grad."""
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)


def param_leaves(tree) -> list[torch.Tensor]:
    """The tensors a params tree stores: plain leaves, and each distinct
    shard of a :class:`ShardedTensor` leaf."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    if isinstance(tree, ShardedTensor):
        return list(tree.shards)
    return [tree]


# ------------------------------------------------------------- contrastive


def _embed(params, ids, mask, cfg: TransformerConfig):
    hidden = encode(params, ids, mask, cfg, flash=False)
    pooled = mean_pool(hidden, mask)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def _contrastive_parts(params, batch, cfg):
    return (_embed(params, batch["q_ids"], batch["q_mask"], cfg),
            _embed(params, batch["d_ids"], batch["d_mask"], cfg))


def _contrastive_join(parts, temperature: float):
    q = torch.cat([p[0] for p in parts])
    d = torch.cat([p[1] for p in parts])
    logits = (q @ d.T) / temperature  # (B, B)
    return F.cross_entropy(logits, torch.arange(q.shape[0], device=q.device))


def contrastive_loss(params, batch, cfg: TransformerConfig, temperature: float = 0.05):
    """batch: dict with q_ids/q_mask/d_ids/d_mask; positives on the
    diagonal, the rest of the batch are negatives (sentence-transformers'
    MultipleNegativesRankingLoss)."""
    return _contrastive_join([_contrastive_parts(params, batch, cfg)], temperature)


def init_train_state(seed, cfg: TransformerConfig, learning_rate: float = 2e-5,
                     device=None) -> tuple[TrainState, AdamW]:
    """Encoder params from ``seed`` (an int, or a ``torch.Generator``'s
    initial seed), moved to ``device`` (the card unless the caller passes
    the CPU), with a fresh optimiser."""
    if isinstance(seed, torch.Generator):
        seed = seed.initial_seed()
    dev = resolve_device(device)
    params = map_params(lambda t: t.to(dev), init_params(seed, cfg))
    tx = AdamW(learning_rate)
    return TrainState(params, tx.init(params), 0), tx


def _split_batch(batch: dict, mesh, d: int) -> dict:
    """dp replica ``d``'s share of a batch: a leaf sharded on the data axis
    gives its local rows, a plain one its ``d``-th slice of the leading dim;
    on the replica's first device."""
    n = mesh.shape[DATA_AXIS]
    dev = mesh.devices[next(p for p in range(mesh.size) if mesh.coords(p)[DATA_AXIS] == d)]
    out = {}
    for k, v in batch.items():
        if isinstance(v, ShardedTensor):
            out[k] = v.local(DATA_AXIS, d)
        else:
            v = torch.as_tensor(v)
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split {n} ways")
            m = v.shape[0] // n
            out[k] = v[d * m:(d + 1) * m]
        out[k] = out[k].to(dev)
    return out


def _replica_params(tree, d: int):
    if isinstance(tree, dict):
        return {k: _replica_params(v, d) for k, v in tree.items()}
    return tree.local(DATA_AXIS, d) if isinstance(tree, ShardedTensor) else tree


def _make_step(parts_fn, join_fn):
    """The shared optimiser step: the objective's per-replica parts, joined
    into the loss, its backward (and the replicas' gradient reduction on a
    mesh), one AdamW step. Both objectives go through here."""

    def train_step(state: TrainState, batch):
        params = state.params
        mesh = tree_mesh(params)
        with torch.enable_grad():
            if mesh is None:
                loss = join_fn([parts_fn(params, batch)])
            else:
                parts = [parts_fn(_replica_params(params, d), _split_batch(batch, mesh, d))
                         for d in range(mesh.shape[DATA_AXIS])]
                loss = join_fn(parts)
            leaves = [t for g in state.opt_state.param_groups for t in g["params"]]
            # a leaf the loss never reads (the encoder's pooler) gets a zero
            # gradient, as in JAX, so AdamW still decays it
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        for t, g in zip(leaves, grads):
            t.grad = g
        if mesh is not None:
            reduce_replica_grads(params)
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        return TrainState(params, state.opt_state, state.step + 1), loss.detach()

    return train_step


def make_train_step(cfg: TransformerConfig, tx, temperature: float = 0.05):
    """Returns train_step(state, batch) -> (state, loss) of the contrastive
    objective; a params tree on a mesh makes it data parallel. ``tx`` is
    JAX's argument: the optimiser it built rides in ``state.opt_state``."""
    return _make_step(lambda params, batch: _contrastive_parts(params, batch, cfg),
                      lambda parts: _contrastive_join(parts, temperature))


# ------------------------------------------------------------- decoder LM


def _lm_parts(params, batch, cfg):
    ids, mask = batch["ids"], batch["mask"]
    logits = decoder_mod.forward(params, ids, mask, cfg, flash=False)  # (B, S, V) f32
    tmask = (mask[:, 1:] * mask[:, :-1]).float()
    ce = F.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten().long(),
                         reduction="none").view_as(tmask)
    return (ce * tmask).sum(), tmask.sum()


def _lm_join(parts):
    dev = parts[0][0].device
    total = sum(p[0].to(dev) for p in parts)
    count = sum(p[1].to(dev) for p in parts)
    return total / count.clamp(min=1.0)


def lm_loss(params, batch, cfg):
    """Next-token cross-entropy of the causal decoder
    (``models/decoder.py``). ``batch``: ids (B, S) with mask (B, S); the
    loss averages over positions whose TARGET is a real token (and whose
    input is too), so padding never contributes; left- or right-padded
    both work."""
    return _lm_join([_lm_parts(params, batch, cfg)])


def init_decoder_train_state(gen, cfg, learning_rate: float = 3e-4,
                             device=None) -> tuple[TrainState, AdamW]:
    """Decoder params from ``gen`` (a ``torch.Generator`` or an int seed),
    moved to ``device`` (the card unless the caller passes the CPU), with a
    fresh optimiser."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    dev = resolve_device(device)
    params = decoder_mod.map_params(lambda t: t.to(dev), decoder_mod.init_params(gen, cfg))
    tx = AdamW(learning_rate)
    return TrainState(params, tx.init(params), 0), tx


def make_decoder_train_step(cfg, tx):
    """Returns train_step(state, batch) -> (state, loss) of the causal LM
    objective; a params tree on a mesh (``decoder.param_partition_specs``)
    makes it data parallel."""
    return _make_step(lambda params, batch: _lm_parts(params, batch, cfg), _lm_join)
