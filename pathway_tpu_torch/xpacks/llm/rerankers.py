"""The reranker seams of the port (counterparts of ``CrossEncoderReranker``
and ``ListwiseLLMReranker`` in ``pathway_tpu/xpacks/llm/rerankers.py``):
plain classes, not Pathway UDFs (the UDF engine is not ported). The
cross-encoder scores (query, doc) pairs a batch at a time; the listwise
reranker has an answer LLM order a window of documents in one prompt."""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.xpacks.llm.llms import decode_serve_error


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


class ListwiseLLMReranker:
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
    reply each."""

    _ID_RE = re.compile(r"\[(\d+)\]")

    def __init__(self, llm, *, window: int = 8, stride: int = 4,
                 max_new_tokens: int | None = None, tenant: str = "rerank"):
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
