"""The reranker seam of the port (counterpart of ``CrossEncoderReranker``
in ``pathway_tpu/xpacks/llm/rerankers.py``): a plain class over the port's
``CrossEncoderModel`` scoring (query, doc) pairs a batch at a time."""

from __future__ import annotations

from typing import Any


class CrossEncoderReranker:
    """``model_name`` is a ready ``CrossEncoderModel``, a preset name
    (``"minilm-l6"``, ``"minilm-l12"``: seeded random weights), or a local
    HF cross-encoder directory with weights. ``custom_kwargs`` go to the
    model's constructor (``device``, ``max_length``, ...)."""

    def __init__(self, model_name: Any = "minilm-l6", *,
                 custom_kwargs: dict | None = None):
        from pathway_tpu_torch.models.checkpoint import has_checkpoint_weights
        from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
        from pathway_tpu_torch.models.transformer import MINILM_L6, MINILM_L12

        presets = {"minilm-l6": MINILM_L6, "minilm-l12": MINILM_L12}
        kwargs = dict(custom_kwargs or {})
        if isinstance(model_name, CrossEncoderModel):
            self.model = model_name
        elif model_name in presets:
            kwargs.setdefault("cfg", presets[model_name])
            self.model = CrossEncoderModel(**kwargs)
        elif isinstance(model_name, str) and has_checkpoint_weights(model_name):
            self.model = CrossEncoderModel.from_pretrained(model_name, **kwargs)
        else:
            self.model = CrossEncoderModel(**kwargs)

    def __call__(self, doc: list[str], query: list[str], **kwargs) -> list[float]:
        """One relevance score per (query, doc) row (None reads as "")."""
        pairs = [(q or "", d or "") for q, d in zip(query, doc)]
        return [float(s) for s in self.model.score_batch(pairs)]

    # two-phase protocol: an epoch's chunks all dispatch, then one drain
    def submit_batch(self, doc: list[str], query: list[str], **kwargs):
        pairs = [(q or "", d or "") for q, d in zip(query, doc)]
        return self.model.score_submit(pairs)

    def resolve_batch(self, handles) -> list[list[float]]:
        return [[float(s) for s in arr] for arr in self.model.score_resolve(handles)]
