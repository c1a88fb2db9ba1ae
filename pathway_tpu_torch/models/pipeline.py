"""Pipeline-parallel encoder forward: a GPipe schedule over a ``pp`` mesh
axis (counterpart of ``pathway_tpu/models/pipeline.py``).

Stage ``j`` holds the ``layers / pp`` consecutive layers of its block on
the device of pp position ``j``. Microbatches stream through the stages:
at tick ``t`` stage ``j`` runs microbatch ``t - j``, and its output (with
the microbatch's mask) hops to stage ``j + 1`` with ``.to(device)``. The
schedule takes ``n_micro + pp - 1`` ticks; the last stage's outputs are
gathered on stage 0's device, as JAX's final ``psum`` replicates them.
Attention is the encoder's ``flash_attn`` seam, as in ``transformer.encode``.
"""

from __future__ import annotations

import torch

from pathway_tpu_torch.models.flash_attention import flash_attn
from pathway_tpu_torch.models.transformer import TransformerConfig, _layer, embed_inputs
from pathway_tpu_torch.parallel.mesh import Mesh

PP_AXIS = "pp"


def encode_pipelined(params: dict, input_ids, attention_mask, cfg: TransformerConfig,
                     mesh: Mesh, n_microbatches: int = 2, token_type_ids=None):
    """Encoder forward with the layer stack pipelined over the mesh's ``pp``
    axis. ``input_ids`` / ``attention_mask``: (B, S), B a multiple of
    ``n_microbatches``. Returns (B, S, H) float32."""
    pp = mesh.shape[PP_AXIS]
    L = next(iter(params["layers"].values())).shape[0]
    if L % pp:
        raise ValueError(f"the pp axis ({pp}) must divide the layer count ({L})")
    B, S = input_ids.shape
    if B % n_microbatches:
        raise ValueError(f"n_microbatches ({n_microbatches}) must divide the batch ({B})")
    mb, n_micro = B // n_microbatches, n_microbatches
    devs = [mesh.devices[p] for p in range(mesh.size)
            if all(v == 0 for a, v in mesh.coords(p).items() if a != PP_AXIS)]
    per = L // pp
    stages = [[{k: v[i].to(dev) for k, v in params["layers"].items()}
               for i in range(j * per, (j + 1) * per)] for j, dev in enumerate(devs)]
    # the embeddings are replicated ahead of the pipeline: only the layer
    # stack is staged
    x = embed_inputs(params, input_ids, cfg, token_type_ids)
    xs = x.reshape(n_micro, mb, S, cfg.hidden)
    masks = attention_mask.to(torch.int32).reshape(n_micro, mb, S)
    inbox: list = [None] * pp
    outputs: list = [None] * n_micro
    for t in range(n_micro + pp - 1):
        nxt: list = [None] * pp
        for j, dev in enumerate(devs):
            m = t - j
            if not 0 <= m < n_micro:
                continue
            h, msk = (xs[m].to(dev), masks[m].to(dev).contiguous()) if j == 0 else inbox[j]

            def core(q, k, v, msk=msk):
                return flash_attn(q, k, v, msk, causal=False)

            for lp in stages[j]:
                h = _layer(h, lp, cfg, core)
            if j == pp - 1:
                outputs[m] = h.float().to(devs[0])
            else:
                nxt[j + 1] = (h.to(devs[j + 1]), msk.to(devs[j + 1]))
        inbox = nxt
    return torch.cat(outputs, dim=0).reshape(B, S, cfg.hidden)
