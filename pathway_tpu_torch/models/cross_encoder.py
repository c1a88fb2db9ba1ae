"""Cross-encoder reranker: (query, doc) pair -> relevance score
(counterpart of ``pathway_tpu/models/cross_encoder.py``).

The pair is encoded jointly ([CLS] q [SEP] d [SEP], BERT segment ids);
the [CLS] hidden state goes through a tanh pooler and a scalar head.
Unlike the embedder, params stay float32 and each product casts its
weight to the compute dtype, as in the JAX cross-encoder.

Each scoring dispatch charges the attention-bytes ledger (``encoder``
path) and construction records the weights in the HBM ledger
(``engine/probes.py``), as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine.probes import record_hbm
from pathway_tpu_torch.models.decoder import params_device_bytes
from pathway_tpu_torch.models.embedder import _record_encoder_attn
from pathway_tpu_torch.models.tokenizer import (
    HashTokenizer,
    load_tokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.models.transformer import (
    MINILM_L6,
    TransformerConfig,
    encode,
    init_params,
    map_params,
)


def score_fn(params, head, input_ids, attention_mask, cfg: TransformerConfig,
             token_type_ids=None, *, n_layers: int | None = None):
    """(B,) float32 scores: encode -> tanh pooler on [CLS] -> head."""
    hidden = encode(params, input_ids, attention_mask, cfg, token_type_ids,
                    n_layers=n_layers)
    cls = hidden[:, 0, :]
    pooled = torch.tanh(cls @ params["pooler"]["w"].float()
                        + params["pooler"]["b"].float())
    return (pooled @ head["w"] + head["b"])[:, 0]


class CrossEncoderModel:
    """Host-facing reranker: [(query, doc)] -> np.ndarray scores.

    ``device=None`` runs on the current CUDA device and raises without
    one; ``device="cpu"`` runs the plain PyTorch path."""

    def __init__(
        self,
        cfg: TransformerConfig = MINILM_L6,
        params=None,
        head=None,
        tokenizer=None,
        max_length: int = 256,
        seed: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer or HashTokenizer(max_length=max_length)
        self.max_length = max_length
        if params is None:
            params = init_params(seed, cfg)
        if head is None:
            gen = torch.Generator().manual_seed(int(seed) + 7)
            head = {
                "w": torch.randn((cfg.hidden, 1), generator=gen) * 0.02,
                "b": torch.zeros((1,)),
            }
        self.params = map_params(lambda p: p.to(self.device), params)
        # HBM ledger: the reranker's param footprint at construction
        for dev, nbytes in params_device_bytes(self.params).items():
            record_hbm("weights.reranker", nbytes, device=dev)
        self.head = map_params(lambda p: p.to(self.device, torch.float32), head)

    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 256, **kw):
        """A local HF cross-encoder checkpoint directory (a BERT sequence
        classifier with a 1-label head, ms-marco-MiniLM style) and its
        tokenizer (through ``transformers``). Raises without a classifier
        head."""
        from pathway_tpu_torch.models.checkpoint import load_encoder_checkpoint
        from pathway_tpu_torch.models.params import from_jax_params

        params, cfg, head = load_encoder_checkpoint(path)
        if head is None:
            raise ValueError(f"{path!r} has no classifier head — not a cross-encoder")
        init = dict(cfg=cfg, params=from_jax_params(params),
                    head=from_jax_params(head),
                    tokenizer=load_tokenizer(path, max_length=max_length),
                    max_length=max_length)
        init.update(kw)  # explicit caller overrides win
        return cls(**init)

    def score_batch(self, pairs: list[tuple[str, str]]) -> np.ndarray:
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        return self.score_resolve([self.score_submit(pairs)])[0]

    def score_submit(self, pairs: list[tuple[str, str]]):
        """Tokenize + enqueue one pair batch; resolve the handle with
        :meth:`score_resolve`."""
        ids, mask, types = self.tokenizer.encode_pairs(
            pairs, max_length=self.max_length, return_types=True
        )
        ids, mask, types = pad_to_buckets(ids, mask, types)
        dev = [torch.from_numpy(a).to(self.device) for a in (ids, mask, types)]
        out = score_fn(self.params, self.head, dev[0], dev[1], self.cfg, dev[2])
        _record_encoder_attn(self.cfg, int(ids.shape[0]), int(ids.shape[1]))
        return out, len(pairs)

    def score_resolve(self, handles) -> list[np.ndarray]:
        return [out[:n].cpu().numpy() for out, n in handles]

    def __call__(self, pairs: list[tuple[str, str]]) -> np.ndarray:
        return self.score_batch(pairs)
