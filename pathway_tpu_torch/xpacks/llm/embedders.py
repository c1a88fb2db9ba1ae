"""The embedder seam of the port (counterpart of
``SentenceTransformerEmbedder`` in ``pathway_tpu/xpacks/llm/embedders.py``).

A plain class, not a Pathway UDF (the UDF engine is not ported), with the
JAX embedder's body: model resolution, batch ``__call__``, the two-phase
``submit_batch`` / ``resolve_batch`` protocol the engine drives, and the
content-keyed dedup (``dedup=True``, the JAX default): a text -> vector
LRU, so re-ingested texts reuse their vectors instead of going to the
device again, and an all-hit batch opens no device handle.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np

# entries kept in the per-embedder dedup LRU (text -> vector); at MiniLM
# width that is ~12 MB of host memory at the bound
DEDUP_MAX = 8192


class SentenceTransformerEmbedder:
    """Sentence embedder over the port's ``SentenceEmbedderModel``.

    ``model`` is a ready ``SentenceEmbedderModel``, a preset name
    (``"minilm-l6"``, ``"minilm-l12"``, ``"bge-small"``: seeded random
    weights), or a local HF directory: with weights it loads through
    ``from_pretrained``, with tokenizer files only through ``from_local``.
    ``init_kwargs`` go to the model's constructor (``device``,
    ``max_length``, the pipeline and tokenizer arguments). The dedup LRU
    keeps ``DEDUP_MAX`` texts, as the JAX package does."""

    def __init__(self, model: Any = "minilm-l6", *, dedup: bool = True, **init_kwargs):
        from pathway_tpu_torch.models.checkpoint import has_checkpoint_weights
        from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
        from pathway_tpu_torch.models.transformer import (
            BGE_SMALL,
            MINILM_L6,
            MINILM_L12,
        )

        presets = {"minilm-l6": MINILM_L6, "minilm-l12": MINILM_L12,
                   "bge-small": BGE_SMALL}
        if isinstance(model, SentenceEmbedderModel):
            self.model = model
        elif isinstance(model, str) and model in presets:
            self.model = SentenceEmbedderModel(cfg=presets[model], **init_kwargs)
        elif isinstance(model, str):
            if has_checkpoint_weights(model):
                self.model = SentenceEmbedderModel.from_pretrained(model, **init_kwargs)
            else:
                self.model = SentenceEmbedderModel.from_local(model, **init_kwargs)
        else:
            raise TypeError(f"unsupported model spec: {model!r}")
        self.dedup = bool(dedup)
        self._dedup: OrderedDict[str, np.ndarray] = OrderedDict()
        self.dedup_stats = {"hits": 0, "misses": 0}

    def _dedup_plan(self, texts: list[str]):
        """Split a batch into cached rows and unique misses.

        Returns ``(plan, miss_texts)``: each plan entry is ``("h", vec)``
        for an LRU hit or ``("m", i)`` indexing ``miss_texts``; duplicate
        texts within the batch share one miss."""
        plan: list[tuple[str, Any]] = []
        miss_texts: list[str] = []
        pos: dict[str, int] = {}
        for t in texts:
            v = self._dedup.get(t)
            if v is not None:
                self._dedup.move_to_end(t)
                self.dedup_stats["hits"] += 1
                plan.append(("h", v))
                continue
            p = pos.get(t)
            if p is None:
                p = pos[t] = len(miss_texts)
                miss_texts.append(t)
                self.dedup_stats["misses"] += 1
            else:
                self.dedup_stats["hits"] += 1
            plan.append(("m", p))
        return plan, miss_texts

    def _dedup_fill(self, plan, miss_texts, miss_vecs) -> list[np.ndarray]:
        for t, v in zip(miss_texts, miss_vecs):
            self._dedup[t] = np.asarray(v)
            if len(self._dedup) > DEDUP_MAX:
                self._dedup.popitem(last=False)
        return [np.array(x if kind == "h" else miss_vecs[x], copy=True)
                for kind, x in plan]

    def __call__(self, input: list[str]) -> list[np.ndarray]:
        """Embed a batch of texts (None reads as ""): one vector each."""
        texts = [t if t is not None else "" for t in input]
        if not self.dedup:
            return list(self.model.embed_batch(texts))
        plan, miss_texts = self._dedup_plan(texts)
        miss_vecs = self.model.embed_batch(miss_texts) if miss_texts else []
        return self._dedup_fill(plan, miss_texts, miss_vecs)

    # two-phase protocol: an epoch's chunks are all submitted, then drained
    # together
    def submit_batch(self, input: list[str]):
        texts = [t if t is not None else "" for t in input]
        if not self.dedup:
            return ("raw", self.model.embed_submit(texts))
        plan, miss_texts = self._dedup_plan(texts)
        # an all-hit batch never touches the device
        h = self.model.embed_submit(miss_texts) if miss_texts else None
        return ("dedup", h, plan, miss_texts)

    def resolve_batch(self, handles, timeout: float | None = None) -> list[list[np.ndarray]]:
        """Vectors of every submitted handle, in order. ``timeout`` bounds
        each pipelined batch's wait for its dispatch."""
        model_handles = [h[1] for h in handles if h[1] is not None]
        resolved = iter(self.model.embed_resolve(model_handles, timeout)
                        if model_handles else [])
        out: list[list[np.ndarray]] = []
        for h in handles:
            if h[0] == "raw":
                out.append(list(next(resolved)))
                continue
            _, mh, plan, miss_texts = h
            miss_vecs = list(next(resolved)) if mh is not None else []
            out.append(self._dedup_fill(plan, miss_texts, miss_vecs))
        return out

    def get_embedding_dimension(self) -> int:
        return self.model.dim

    def close(self) -> None:
        self.model.close()
