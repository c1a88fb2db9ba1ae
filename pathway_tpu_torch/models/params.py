"""Parameter bridge between the JAX package's pytrees and the port.

``from_jax_params`` takes a JAX pytree as numpy arrays and returns the same
nested dict of torch tensors; ``to_numpy`` goes the other way. It serves
the encoder (the stacked ``(L, ...)`` layer leaves of
``pathway_tpu/models/transformer.py`` ``init_params``, a cross-encoder
``head`` dict) and the decoder alike: ``pathway_tpu/models/decoder.py``
``init_params`` with its tied ``wte``, the int8 payloads and f32 ``_scale``
leaves after ``quantize_params``, and the serving pools (int8 and int32
planes). Values and dtypes are carried bit for bit (bf16 as its 16-bit
patterns). The port imports no JAX: callers convert with ``np.asarray`` on
their side.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.models.transformer import map_params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the 16-bit patterns as they are
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device="cpu") -> dict:
    """Nested dict of numpy arrays (a JAX param pytree or pool) -> the same
    nesting of tensors on ``device``, dtypes kept."""
    return map_params(lambda a: _to_tensor(a, device), tree)


def to_numpy(tree) -> dict:
    """Nested dict of tensors -> numpy arrays on the host. bf16 tensors
    come back as float32 numpy arrays (exactly: every bf16 value is an f32
    value); other dtypes are kept."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_params(conv, tree)
