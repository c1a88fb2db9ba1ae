"""Embedder UDFs (counterpart of ``pathway_tpu/xpacks/llm/embedders.py``;
reference ``xpacks/llm/embedders.py:64-413``).

``SentenceTransformerEmbedder`` is a batched ``pw.UDF``: each engine
microbatch is tokenized on the host and encoded on the card by the port's
``SentenceEmbedderModel``, whose attention is the ``flash_attn`` kernel
(``csrc/flash_attn.cu``) on CUDA tensors. ``deferred=True`` selects the
fully-async executor: the engine submits an epoch's chunks through the
two-phase ``submit_batch`` / ``resolve_batch`` protocol and a drain thread
injects the vectors at a later engine time. The content-keyed dedup
(``dedup=True``, JAX's ``embed_dedup`` default) keeps a text -> vector LRU,
so re-ingested texts reuse their vectors, and an all-hit batch opens no
device handle.

Called on a list of texts instead of a column, the embedder embeds the
batch directly (the plain seam the ingest path and ``FusedRAGPipeline``
drive). The API-client embedders (``OpenAIEmbedder``, ``LiteLLMEmbedder``,
``GeminiEmbedder``) keep JAX's signatures and the reference's async-UDF
shape; each imports its SDK when it is called and raises JAX's
``ImportError`` without it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np

from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.expression import ColumnExpression

# entries kept in the per-embedder dedup LRU (text -> vector); at MiniLM
# width that is ~12 MB of host memory at the bound
DEDUP_MAX = 8192


class BaseEmbedder(udfs.UDF):
    """Base embedder UDF (reference ``BaseEmbedder``, embedders.py:64).

    ``__call__`` on a string column returns an embedding-vector column;
    ``get_embedding_dimension`` embeds a probe string to discover the dim.
    """

    def get_embedding_dimension(self, **kwargs) -> int:
        return len(self._embed_sync(".", **kwargs))

    def _embed_sync(self, text: str, **kwargs):
        import asyncio
        import inspect

        fun = self.__wrapped__
        if inspect.iscoroutinefunction(fun):
            return asyncio.run(fun(text, **kwargs))
        if self.batch:
            return fun([text], **{k: [v] for k, v in kwargs.items()})[0]
        return fun(text, **kwargs)


class SentenceTransformerEmbedder(BaseEmbedder):
    """Sentence embedder over the port's ``SentenceEmbedderModel``
    (reference ``SentenceTransformerEmbedder``, embedders.py:270-313).

    ``model`` is a ready ``SentenceEmbedderModel``, a preset name
    (``"minilm-l6"``, ``"minilm-l12"``, ``"bge-small"``: seeded random
    weights), or a local HF directory: with weights it loads through
    ``from_pretrained``, with tokenizer files only through ``from_local``.
    ``device`` is the model's (``None``: the card, raising without one;
    ``"cpu"`` only when asked); ``init_kwargs`` go to the model's
    constructor (``max_length``, the pipeline and tokenizer arguments).
    ``max_batch_size`` bounds the rows of one device call, as in JAX."""

    def __init__(
        self,
        model: Any = "minilm-l6",
        call_kwargs: dict = {},
        device: Any = None,
        *,
        max_batch_size: int | None = 1024,
        cache_strategy: udfs.CacheStrategy | None = None,
        deferred: bool = False,
        dedup: bool = True,
        **init_kwargs,
    ):
        # deferred=True: the epoch submits the embed chunks and moves on;
        # the vectors are injected at a later engine time (derived tables
        # see them after the raw rows, as with the reference's fully-async
        # UDFs)
        super().__init__(
            deterministic=True,
            batch=True,
            max_batch_size=max_batch_size,
            cache_strategy=cache_strategy,
            executor=udfs.fully_async_executor() if deferred else None,
        )
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
            self.model = SentenceEmbedderModel(cfg=presets[model], device=device,
                                               **init_kwargs)
        elif isinstance(model, str):
            if has_checkpoint_weights(model):
                self.model = SentenceEmbedderModel.from_pretrained(
                    model, device=device, **init_kwargs)
            else:
                self.model = SentenceEmbedderModel.from_local(
                    model, device=device, **init_kwargs)
        else:
            raise TypeError(f"unsupported model spec: {model!r}")
        self.device = self.model.device
        self.kwargs = dict(call_kwargs)
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

    def __wrapped__(self, input: list[str], **kwargs) -> list[np.ndarray]:
        """Embed a batch of texts (None reads as ""): one vector each."""
        texts = [t if t is not None else "" for t in input]
        if not self.dedup:
            return list(self.model.embed_batch(texts))
        plan, miss_texts = self._dedup_plan(texts)
        miss_vecs = self.model.embed_batch(miss_texts) if miss_texts else []
        return self._dedup_fill(plan, miss_texts, miss_vecs)

    # two-phase protocol (picked up by UDF._call_batched): an epoch's
    # chunks are all submitted, then drained together
    def submit_batch(self, input: list[str], **kwargs):
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

    # the token-level path of the late-interaction bank (no dedup: token
    # states are not pooled vectors)
    def embed_tokens_submit(self, input: list[str], dc: int | None = None):
        texts = [t if t is not None else "" for t in input]
        return self.model.token_bank_submit(texts, dc=dc)

    def embed_tokens_resolve(self, handles, timeout: float | None = None):
        """-> ``[(payload int8 (n, S, dc), scale f32 (n, S, 1))]`` per
        submitted handle."""
        return self.model.token_bank_resolve(handles, timeout)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.model.dim

    def __call__(self, input, **kwargs):
        """On a column expression: the UDF's vector column. On a list of
        texts: their vectors, embedded now."""
        if isinstance(input, ColumnExpression):
            return super().__call__(input, **kwargs)
        return self.__wrapped__(input, **kwargs)

    def close(self) -> None:
        self.model.close()


class OpenAIEmbedder(BaseEmbedder):
    """OpenAI embeddings API client UDF (reference ``OpenAIEmbedder``,
    embedders.py:85-178). Async, retried/capacity-limited via executor."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "text-embedding-3-small",
        **openai_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(openai_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    async def __wrapped__(self, input: str, **kwargs) -> np.ndarray:
        try:
            import openai
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("OpenAIEmbedder requires the `openai` package") from exc
        kwargs = {**self.kwargs, **kwargs}
        api_kwargs = {
            k: kwargs.pop(k)
            for k in ("api_key", "base_url", "organization")
            if k in kwargs
        }
        client = openai.AsyncOpenAI(**api_kwargs)
        ret = await client.embeddings.create(input=[input or "."], **kwargs)
        return np.array(ret.data[0].embedding)


class LiteLLMEmbedder(BaseEmbedder):
    """LiteLLM multi-provider embedder (reference ``LiteLLMEmbedder``,
    embedders.py:180-268)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        **llmlite_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(llmlite_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    async def __wrapped__(self, input: str, **kwargs) -> np.ndarray:
        try:
            import litellm
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("LiteLLMEmbedder requires the `litellm` package") from exc
        ret = await litellm.aembedding(input=[input or "."], **{**self.kwargs, **kwargs})
        return np.array(ret.data[0]["embedding"])


class GeminiEmbedder(BaseEmbedder):
    """Google Gemini embeddings client (reference ``GeminiEmbedder``,
    embedders.py:330-413)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "models/text-embedding-004",
        **genai_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(genai_kwargs)
        self.model = model

    def __wrapped__(self, input: str, **kwargs) -> np.ndarray:
        try:
            import google.generativeai as genai
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "GeminiEmbedder requires the `google-generativeai` package"
            ) from exc
        response = genai.embed_content(
            model=self.model, content=input or ".", **{**self.kwargs, **kwargs}
        )
        return np.array(response["embedding"])
