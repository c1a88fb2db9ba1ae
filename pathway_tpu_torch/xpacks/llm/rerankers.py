"""Reranker UDFs (counterpart of ``pathway_tpu/xpacks/llm/rerankers.py``;
reference ``xpacks/llm/rerankers.py:15-345``).

``CrossEncoderReranker`` and ``EncoderReranker`` are batched ``pw.UDF``s:
a whole engine microbatch of (doc, query) pairs is scored in one call of
the port's encoder on the card (attention through the ``flash_attn``
kernel), and an epoch's chunks go out through the two-phase
``submit_batch`` / ``resolve_batch`` protocol and drain together, as in
JAX. Called on lists instead of columns they score the pairs directly
(the plain seam ``FusedRAGPipeline`` and the ingest tests drive).

Both declare ``deterministic=False`` where JAX declares True: a bf16
encode's scores follow the padded height of the batch it rode in, so a
retraction scored again could differ from its insertion and fail to
cancel it. The engine's replay cache returns the inserted score instead,
and each pair is scored once.

``LLMReranker`` asks a chat for a 1-5 rating; ``ListwiseLLMReranker`` has
a chat order a window of documents in one prompt (over ``pw.Json`` docs as
a UDF, or through ``rerank_batch`` directly). ``FlashRankReranker`` is
JAX's client of the ``flashrank`` package, imported when it is built.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.xpacks.llm.llms import BaseChat, decode_serve_error

# ruff: noqa: E501


@udfs.udf
def rerank_topk_filter(
    docs: list[Any], scores: list[float], k: int = 5
) -> tuple[list[Any], list[float]]:
    """Keep the top-``k`` docs by rerank score (reference
    ``rerank_topk_filter``, rerankers.py:15).

    ``k > len(docs)`` returns ALL docs in score order (a slice past the
    end, never an error); ``k <= 0`` returns nothing. Docs beyond the
    score list carry no ranking signal and are dropped rather than
    ordered arbitrarily.
    """
    if not docs or k <= 0:
        return [], []
    docs = docs[: len(scores)]
    # stable sort with original-index tie-break: tied scores must always
    # resolve the same way (plain argsort reversed would also flip the
    # order WITHIN ties)
    order = np.argsort(
        -np.asarray(scores[: len(docs)], dtype=np.float64), kind="stable"
    )[:k]
    docs_sorted = [docs[i] for i in order]
    scores_sorted = [float(scores[i]) for i in order]
    return docs_sorted, scores_sorted


class CrossEncoderReranker(udfs.UDF):
    """Cross-encoder reranker over the port's ``CrossEncoderModel``
    (reference ``CrossEncoderReranker``, rerankers.py:186-249). Batched:
    one padded encoder call per microbatch.

    ``model_name`` is a ready ``CrossEncoderModel``, a preset name
    (``"minilm-l6"``, ``"minilm-l12"``: seeded random weights), or a local
    HF cross-encoder directory with weights. ``custom_kwargs`` go to the
    model's constructor (``device``, ``max_length``, ...)."""

    def __init__(
        self,
        model_name: Any = "minilm-l6",
        *,
        max_batch_size: int | None = 512,
        cache_strategy: udfs.CacheStrategy | None = None,
        custom_kwargs: dict | None = None,
    ):
        super().__init__(
            deterministic=False,
            batch=True,
            max_batch_size=max_batch_size,
            cache_strategy=cache_strategy,
            return_type=float,
        )
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

    def __wrapped__(self, doc: list[str], query: list[str], **kwargs) -> list[float]:
        """One relevance score per (query, doc) row (None reads as "")."""
        pairs = [(q or "", d or "") for q, d in zip(query, doc)]
        return [float(s) for s in self.model.score_batch(pairs)]

    # two-phase protocol: an epoch's chunks all dispatch, then one drain
    def submit_batch(self, doc: list[str], query: list[str], **kwargs):
        pairs = [(q or "", d or "") for q, d in zip(query, doc)]
        return self.model.score_submit(pairs)

    def resolve_batch(self, handles) -> list[list[float]]:
        return [[float(s) for s in arr] for arr in self.model.score_resolve(handles)]

    def __call__(self, doc, query, **kwargs):
        """On columns: the UDF's score column. On lists: the scores now."""
        if isinstance(doc, ColumnExpression) or isinstance(query, ColumnExpression):
            return super().__call__(doc, query, **kwargs)
        return self.__wrapped__(doc, query, **kwargs)


class EncoderReranker(udfs.UDF):
    """Bi-encoder reranker: cosine of (query, doc) embeddings (reference
    ``EncoderReranker``, rerankers.py:251-317). Batched on the card."""

    def __init__(
        self,
        model_name: Any = "minilm-l6",
        *,
        max_batch_size: int | None = 1024,
        cache_strategy: udfs.CacheStrategy | None = None,
        custom_kwargs: dict | None = None,
    ):
        super().__init__(
            deterministic=False,
            batch=True,
            max_batch_size=max_batch_size,
            cache_strategy=cache_strategy,
            return_type=float,
        )
        from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

        self.embedder = SentenceTransformerEmbedder(model_name, **(custom_kwargs or {}))

    def __wrapped__(self, doc: list[str], query: list[str], **kwargs) -> list[float]:
        # through the embedder UDF: its content-keyed dedup collapses the
        # query column's repeats (one text per candidate doc) to one row
        q = np.asarray(self.embedder.__wrapped__(list(query)))
        d = np.asarray(self.embedder.__wrapped__(list(doc)))
        # embeddings are unit-norm, so dot product == cosine similarity
        return [float(s) for s in np.sum(q * d, axis=1)]

    # two-phase protocol: both embed dispatches per chunk go out eagerly;
    # the single resolve drains every (query, doc) pair of the epoch
    def submit_batch(self, doc: list[str], query: list[str], **kwargs):
        hq = self.embedder.submit_batch(list(query))
        hd = self.embedder.submit_batch(list(doc))
        return (hq, hd)

    def resolve_batch(self, handles) -> list[list[float]]:
        flat = []
        for hq, hd in handles:
            flat.append(hq)
            flat.append(hd)
        arrs = self.embedder.resolve_batch(flat)
        out = []
        for i in range(0, len(arrs), 2):
            q = np.asarray(arrs[i])
            d = np.asarray(arrs[i + 1])
            out.append([float(s) for s in np.sum(q * d, axis=1)])
        return out


class LLMReranker(udfs.UDF):
    """Ask a chat model to rate doc relevance 1-5 (reference ``LLMReranker``,
    rerankers.py:58-184)."""

    prompt_template = (
        "Rate how relevant the document is to the query on a scale 1 to 5. "
        "Reply with a single digit.\n\nQuery: {query}\n\nDocument: {doc}\n\nRating:"
    )

    def __init__(
        self,
        llm: BaseChat,
        *,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        use_logit_bias: bool | None = None,
    ):
        super().__init__(cache_strategy=cache_strategy, return_type=float)
        self.llm = llm
        self.use_logit_bias = use_logit_bias

    def __wrapped__(self, doc: str, query: str, **kwargs) -> float:
        from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync

        prompt = self.prompt_template.format(query=query, doc=doc)
        messages = [{"role": "user", "content": prompt}]
        if getattr(self.llm, "batch", False):
            # the decoder chat is a batch UDF: the prompt goes as a one-row
            # batch (a continuous DecoderChat serves it through its pool)
            response = _coerce_sync(self.llm.__wrapped__)([messages], **kwargs)[0]
        else:
            response = _coerce_sync(self.llm.__wrapped__)(messages, **kwargs)
        digits = [c for c in str(response) if c.isdigit()]
        if not digits:
            raise ValueError(f"reranker got non-numeric response: {response!r}")
        return float(digits[0])


class ListwiseLLMReranker(udfs.UDF):
    """RankLLM-style listwise reranker: a window of candidates goes into
    ONE prompt and the model answers with a permutation (``[2] > [1] >
    [3]``), instead of scoring each (query, doc) pair alone.

    The window slides bottom-up with overlap (RankGPT's schedule), so a
    relevant document deep in the list can climb to the top across
    windows. A malformed or failed reply leaves its window in its incoming
    (cross-encoder) order. ``llm`` is the port's ``DecoderChat``: with a
    continuous server, every window prompt of a round enters its slot pool
    together (``submit_batch(..., tenant=)``, one ``resolve_batch``);
    otherwise any callable taking a list of message lists and returning one
    reply each. As a UDF it reorders each row's docs (``pw.Json``, dicts or
    strings) for its query."""

    _ID_RE = re.compile(r"\[(\d+)\]")

    def __init__(self, llm, *, window: int = 8, stride: int = 4,
                 max_new_tokens: int | None = None, tenant: str = "rerank",
                 cache_strategy: udfs.CacheStrategy | None = None):
        super().__init__(
            deterministic=bool(getattr(llm, "deterministic", False)),
            batch=True,
            cache_strategy=cache_strategy,
        )
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if not 1 <= stride <= window:
            raise ValueError(f"stride must be in [1, window({window})], got {stride}")
        self.llm = llm
        self.window = int(window)
        self.stride = int(stride)
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant

    # ---------------------------------------------------- prompt / parse
    def _window_prompt(self, query: str, docs: list[str]) -> str:
        n = len(docs)
        lines = [
            f"I will provide {n} passages, each labeled with an identifier "
            f"like [1]. Rank them by relevance to the query.",
            f"Query: {query}",
        ]
        lines.extend(f"[{i + 1}] {d}" for i, d in enumerate(docs))
        lines.append(
            f"Rank the {n} passages above in descending order of relevance "
            "to the query. Answer ONLY with identifiers separated by >, "
            "for example [2] > [1] > [3]. Do not write anything else."
        )
        return "\n".join(lines)

    def _parse_permutation(self, text: Any, n: int) -> list[int] | None:
        """0-based permutation of ``range(n)`` from a ranking reply, or
        None for a malformed or failed reply (the fallback signal)."""
        if not text or decode_serve_error(text) is not None:
            return None
        seen: set[int] = set()
        perm: list[int] = []
        for tok in self._ID_RE.findall(str(text)):
            i = int(tok) - 1
            if 0 <= i < n and i not in seen:
                seen.add(i)
                perm.append(i)
        if not perm:
            return None
        # ids the model left out keep their incoming order, after the rest
        perm.extend(i for i in range(n) if i not in seen)
        return perm

    def _window_starts(self, n: int) -> list[int]:
        """Bottom-up overlapping window starts for an n-doc list."""
        if n <= 1:
            return []
        if n <= self.window:
            return [0]
        starts = []
        s = n - self.window
        while s > 0:
            starts.append(s)
            s -= self.stride
        starts.append(0)
        return starts

    # ------------------------------------------------------------- chat
    def _chat_round(self, prompts: list[str], **kwargs) -> list[Any]:
        msgs = [[{"role": "user", "content": p}] for p in prompts]
        kw = dict(kwargs)
        if self.max_new_tokens is not None:
            kw.setdefault("max_new_tokens", self.max_new_tokens)
        if getattr(self.llm, "server", None) is not None:
            # a continuous server: the round's prompts share its slot pool
            kw.setdefault("tenant", self.tenant)
            return self.llm.resolve_batch([self.llm.submit_batch(msgs, **kw)])[0]
        return list(self.llm(msgs, **kw))

    # ------------------------------------------------------------- core
    def rerank_batch(self, queries: list[str], docs_lists: list[list[str]],
                     **kwargs) -> list[list[int]]:
        """Per-query permutation (indices into its doc list, best first).
        Rounds run in lockstep: round ``r`` sends the r-th window of every
        query that still has one in one chat call."""
        orders = [list(range(len(d))) for d in docs_lists]
        rounds = [self._window_starts(len(d)) for d in docs_lists]
        n_rounds = max((len(r) for r in rounds), default=0)
        for r in range(n_rounds):
            live = [i for i in range(len(queries)) if r < len(rounds[i])]
            prompts = []
            for i in live:
                s = rounds[i][r]
                w = orders[i][s : s + self.window]
                prompts.append(self._window_prompt(
                    queries[i] or "", [str(docs_lists[i][j]) for j in w]))
            replies = self._chat_round(prompts, **kwargs)
            for i, reply in zip(live, replies):
                s = rounds[i][r]
                w = orders[i][s : s + self.window]
                perm = self._parse_permutation(reply, len(w))
                if perm is not None:
                    orders[i][s : s + self.window] = [w[p] for p in perm]
        return orders

    def __wrapped__(self, docs: list[list[Any]], query: list[str],
                    **kwargs) -> list[list[Any]]:
        texts = [[_doc_text(d) for d in (row or [])] for row in docs]
        perms = self.rerank_batch(list(query), texts, **kwargs)
        return [[row[j] for j in perm]
                for row, perm in zip([list(r or []) for r in docs], perms)]


class FlashRankReranker(udfs.UDF):
    """FlashRank listwise reranker (reference ``FlashRankReranker``,
    rerankers.py:319-345). Gated on the ``flashrank`` package."""

    def __init__(
        self,
        model_name: str = "ms-marco-TinyBERT-L-2-v2",
        *,
        cache_strategy: udfs.CacheStrategy | None = None,
        max_length: int = 512,
    ):
        super().__init__(cache_strategy=cache_strategy, return_type=float)
        try:
            from flashrank import Ranker
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "FlashRankReranker requires the `flashrank` package"
            ) from exc
        self.ranker = Ranker(model_name=model_name, max_length=max_length)

    def __wrapped__(self, doc: str, query: str) -> float:
        from flashrank import RerankRequest

        results = self.ranker.rerank(
            RerankRequest(query=query, passages=[{"text": doc}])
        )
        return float(results[0]["score"])


def _doc_text(d: Any) -> str:
    """Text payload of a retrieved doc (Json/dict/str)."""
    if isinstance(d, Json):
        d = d.value
    if isinstance(d, dict):
        return str(d.get("text", ""))
    return str(d)


@udfs.udf
def unwrap_doc_texts(docs: list[Any]) -> list[str]:
    """Extract text fields from retrieved doc dicts/Jsons."""
    return [_doc_text(d) for d in docs or []]
