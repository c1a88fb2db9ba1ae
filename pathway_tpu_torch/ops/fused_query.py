"""RAG query pipeline with a device-resident corpus (counterpart of
``pathway_tpu/ops/fused_query.py``, plain dense path).

Everything a query touches stays on the card: the embedding corpus (the
brute-force index matrix) and the documents' token ids. A query runs

    tokenize (host)  ->  encode + pool + normalise  ->  gemm + top-k  ->
    gather doc tokens  ->  assemble [CLS] q [SEP] d [SEP] pairs  ->
    cross-encoder  ->  one device-to-host copy

PyTorch runs eagerly, so the JAX package's one-executable-per-query
becomes one stream of launches per query, with no host sync before the
final copy.

With ``rerank_cascade`` (off by default, as JAX's flag) the rerank is
cascaded, still one stream of launches: a cheap pass through the first
``depth`` cross-encoder layers, seeded with the retrieval score, ranks
all k candidates, and only the top ``keep`` survivors pay the full
cross-encoder. The MaxSim, LLM-rerank and sharded branches of the JAX
pipeline are not part of this path. Each query counts its device dispatch
(``fused_retrieve`` / ``fused_retrieve_rerank`` / ``fused_rerank_cascade``)
and ``retrieve`` the queries its dense index answered, as in JAX
(``engine/probes.py``); the cascade charges its stages' pairs and FLOPs to
the cascade ledger.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.engine.probes import (
    record_cascade,
    record_device_dispatch,
    record_retrieval_backend,
)
from pathway_tpu_torch.models.cross_encoder import score_fn
from pathway_tpu_torch.models.embedder import embed_fn
from pathway_tpu_torch.models.tokenizer import PAD_ID, SEP_ID, pad_to_buckets
from pathway_tpu_torch.models.transformer import TransformerConfig
from pathway_tpu_torch.ops import next_pow2
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, search_corpus, topk_scores

_NEG_INF = -1e30


def _encoder_flops(cfg: TransformerConfig, seq: int, n_layers: int,
                   pairs: int) -> float:
    """Model FLOPs of ``pairs`` sequences of length ``seq`` through
    ``n_layers`` encoder layers: the qkv, attention-out and MLP products
    plus the two S^2 attention products."""
    h, i = cfg.hidden, cfg.intermediate
    per_layer = 2 * seq * h * (3 * h + h + 2 * i) + 4 * seq * seq * h
    return float(pairs) * n_layers * per_layer


def _assemble_pairs(q_ids, q_len, doc_tokens, doc_lens, pair_seq: int):
    """Build (Qb, k, pair_seq) cross-encoder inputs on the device:
    ``[CLS] q [SEP] d [SEP]`` with masks and BERT segment ids. ``q_ids``
    (Qb, S) rows are already ``[CLS] q [SEP]`` of true length ``q_len``
    (Qb,); ``doc_tokens`` (Qb, k, dseq) carry bare doc tokens of
    ``doc_lens`` (Qb, k) each."""
    qb, k, dseq = doc_tokens.shape
    dev = doc_tokens.device
    j = torch.arange(pair_seq, device=dev)[None, None, :]            # (1,1,P)
    width = q_ids.shape[1]
    if width < pair_seq:
        q_ids = torch.nn.functional.pad(q_ids, (0, pair_seq - width))
    q_part = q_ids[:, :pair_seq][:, None, :]                         # (Qb,1,P)
    ql = q_len[:, None, None]                                        # (Qb,1,1)
    dpos = (j - ql).clamp(0, dseq - 1).expand(qb, k, pair_seq)
    d_vals = torch.gather(doc_tokens, 2, dpos.long())                # (Qb,k,P)
    end = ql + doc_lens[:, :, None]                                  # SEP slot
    pair = torch.where(
        j < ql,
        q_part.expand(qb, k, pair_seq),
        torch.where(
            j < end, d_vals,
            torch.where(j == end, SEP_ID, PAD_ID).to(d_vals.dtype),
        ),
    )
    mask = (j <= end).to(torch.int32)
    ttype = ((j >= ql) & (j <= end)).to(torch.int32)
    return pair.to(torch.int32), mask, ttype


def _pair_scores(r_params, r_head, pair, mask, ttype,
                 r_cfg: TransformerConfig, n_layers: int | None = None):
    """Cross-encoder scores for a flat (B, P) pair batch."""
    return score_fn(r_params, r_head, pair, mask, r_cfg, ttype,
                    n_layers=n_layers)


def _retrieve_and_assemble(e_params, q_ids, q_mask, corpus, valid, doc_tokens,
                           doc_lens, e_cfg: TransformerConfig, k: int,
                           metric: str, pair_seq: int):
    """Embed queries -> top-k over the corpus -> gather the hit documents'
    tokens -> assemble the (Qb, k, pair_seq) pair inputs: the front half
    of the plain and the cascaded rerank."""
    emb = embed_fn(e_params, q_ids, q_mask, e_cfg)                  # (Qb, H)
    scores, idx = search_corpus(corpus, valid, emb, k, metric)      # (Qb, k)
    d_tok = doc_tokens[idx]                                          # (Qb,k,dseq)
    d_len = doc_lens[idx]                                            # (Qb, k)
    q_len = q_mask.sum(dim=1).to(torch.int32)
    pair, mask, ttype = _assemble_pairs(q_ids, q_len, d_tok, d_len, pair_seq)
    return scores, idx, pair, mask, ttype


def _retrieve_rerank(e_params, q_ids, q_mask, corpus, valid, doc_tokens,
                     doc_lens, r_params, r_head, e_cfg: TransformerConfig,
                     r_cfg: TransformerConfig, k: int, metric: str,
                     pair_seq: int):
    """Retrieve and assemble, then cross-encode the (Qb * k) pairs as one
    flat batch. Returns (knn_scores, idx, rerank_scores, order), each
    (Qb, k)."""
    scores, idx, pair, mask, ttype = _retrieve_and_assemble(
        e_params, q_ids, q_mask, corpus, valid, doc_tokens, doc_lens, e_cfg,
        k, metric, pair_seq)
    qb = q_ids.shape[0]
    r_scores = _pair_scores(
        r_params, r_head, pair.reshape(qb * k, pair_seq),
        mask.reshape(qb * k, pair_seq), ttype.reshape(qb * k, pair_seq),
        r_cfg,
    ).reshape(qb, k)
    # hits beyond the live corpus (padded capacity) must sort last
    r_scores = torch.where(scores <= _NEG_INF / 2, _NEG_INF, r_scores)
    order = torch.argsort(-r_scores, dim=1, stable=True)
    return scores, idx, r_scores, order


def _retrieve_rerank_cascade(e_params, q_ids, q_mask, corpus, valid,
                             doc_tokens, doc_lens, r_params, r_head,
                             e_cfg: TransformerConfig, r_cfg: TransformerConfig,
                             k: int, metric: str, pair_seq: int, depth: int,
                             keep: int, seed_weight: float):
    """Cascaded rerank: the first ``depth`` cross-encoder layers plus the
    score head, seeded with the retrieval score, rank all k candidates;
    the top ``keep`` survivors pay the full cross-encoder.

    Returns (knn_scores, idx, rerank_scores, order), each (Qb, k).
    ``order`` lists the survivors first (by full-depth score), then the
    rest (by cheap score); ``rerank_scores`` holds full-depth scores at
    survivor positions and cheap scores elsewhere, two ranges each ordered
    but not calibrated against each other."""
    scores, idx, pair, mask, ttype = _retrieve_and_assemble(
        e_params, q_ids, q_mask, corpus, valid, doc_tokens, doc_lens, e_cfg,
        k, metric, pair_seq)
    qb = q_ids.shape[0]

    def flat(a, n):
        return a.reshape(qb * n, pair_seq)

    cheap = _pair_scores(r_params, r_head, flat(pair, k), flat(mask, k),
                         flat(ttype, k), r_cfg, n_layers=depth).reshape(qb, k)
    # seed with the ranking signal retrieval already paid for
    cheap = cheap + float(seed_weight) * scores.float()
    cheap = torch.where(scores <= _NEG_INF / 2, _NEG_INF, cheap)
    _, surv = topk_scores(cheap, keep)                              # (Qb, keep)

    def gather(a):
        return torch.gather(a, 1, surv[:, :, None].expand(-1, -1, pair_seq))

    full = _pair_scores(r_params, r_head, flat(gather(pair), keep),
                        flat(gather(mask), keep), flat(gather(ttype), keep),
                        r_cfg).reshape(qb, keep)
    full = torch.where(torch.gather(scores, 1, surv) <= _NEG_INF / 2, _NEG_INF, full)
    r_scores = cheap.scatter(1, surv, full)
    surv_sorted = torch.gather(surv, 1, torch.argsort(-full, dim=1, stable=True))
    # survivor slots drop to -inf, strictly below the _NEG_INF of padded
    # candidates: otherwise (live docs < keep) they tie, the sort takes
    # survivors again and ``order`` stops being a permutation
    rest = cheap.scatter(1, surv, torch.full_like(full, float("-inf")))
    rest_order = torch.argsort(-rest, dim=1, stable=True)
    order = torch.cat([surv_sorted, rest_order[:, : k - keep]], dim=1)
    return scores, idx, r_scores, order


class FusedRAGPipeline:
    """Device-resident retrieval (+ optional rerank).

    ``add(keys, texts)`` embeds documents into the brute-force corpus AND
    stores their token ids on the device; ``retrieve`` /
    ``retrieve_rerank`` then run on the card up to one final copy.
    ``*_device`` variants return device tensors without a host sync.
    ``pair_buckets`` pads rerank pairs to the pow2 bucket of the longest
    real pair instead of ``pair_seq``. ``rerank_cascade`` turns the
    cascaded rerank on, with ``rerank_cascade_depth`` cheap layers (0:
    half the reranker's), ``rerank_cascade_survivors`` (0: ``max(8, k //
    2)``) and ``rerank_seed_weight``; these four are read per call and may
    change between calls, as JAX reads its flags. Every default is the
    JAX flag default."""

    def __init__(self, embedder, reranker=None, *,
                 reserved_space: int = 1024, metric: str = "cos",
                 doc_seq: int = 96, pair_seq: int = 160,
                 pair_buckets: bool = True, rerank_cascade: bool = False,
                 rerank_cascade_depth: int = 0,
                 rerank_cascade_survivors: int = 0,
                 rerank_seed_weight: float = 0.25):
        self.embedder = embedder          # SentenceEmbedderModel
        self.reranker = reranker          # CrossEncoderModel | None
        self.metric = metric
        self.doc_seq = doc_seq
        self.pair_seq = pair_seq
        self.pair_buckets = pair_buckets
        self.rerank_cascade = rerank_cascade
        self.rerank_cascade_depth = rerank_cascade_depth
        self.rerank_cascade_survivors = rerank_cascade_survivors
        self.rerank_seed_weight = rerank_seed_weight
        # the rerank pair is [CLS] q [SEP] d [SEP]: rerank queries truncate
        # to this budget so they never crowd the document out
        self._rerank_q_budget = pair_seq - doc_seq - 1
        if self._rerank_q_budget < 8:
            raise ValueError(
                f"pair_seq={pair_seq} leaves only {self._rerank_q_budget} "
                f"query tokens next to doc_seq={doc_seq}; raise pair_seq "
                "or lower doc_seq"
            )
        self.device = embedder.device
        self.index = BruteForceKnnIndex(
            dimensions=embedder.cfg.hidden,
            reserved_space=reserved_space, metric=metric, device=self.device,
        )
        cap = self.index.capacity
        self._doc_tokens = torch.zeros((cap, doc_seq), dtype=torch.int32,
                                       device=self.device)
        self._doc_lens = torch.zeros((cap,), dtype=torch.int32,
                                     device=self.device)
        # longest stored doc-token row, tracked on the host so the pair
        # bucket needs no device round trip; never lowered on remove, so it
        # stays a safe upper bound
        self._max_doc_len = 0

    # ------------------------------------------------------------- ingest
    def _doc_token_rows(self, texts: list[str]):
        """Each doc's tokens without [CLS] / [SEP], at most ``doc_seq``,
        zero-padded: one batch encode at ``doc_seq + 2``."""
        ids, mask = self.embedder.tokenizer(texts, max_length=self.doc_seq + 2)
        lens = np.maximum(mask.sum(axis=1) - 2, 0).astype(np.int32)
        body = ids[:, 1 : 1 + self.doc_seq]
        rows = np.zeros((len(texts), self.doc_seq), dtype=np.int32)
        live = np.arange(body.shape[1])[None, :] < lens[:, None]
        rows[:, : body.shape[1]] = np.where(live, body, 0)
        return rows, lens

    def add(self, keys: list, texts: list[str]) -> None:
        """Embed ``texts`` into the corpus and store their tokens, both
        written in place on the device."""
        if not keys:
            return
        start = self.index.n
        m = self.embedder
        ids, mask = m.tokenize(list(texts))
        self.index.add_embed(keys, m.params, ids, mask, m.cfg, embed_fn)
        cap = self.index.capacity
        if cap != self._doc_tokens.shape[0]:
            grow = cap - self._doc_tokens.shape[0]
            self._doc_tokens = torch.nn.functional.pad(
                self._doc_tokens, (0, 0, 0, grow))
            self._doc_lens = torch.nn.functional.pad(self._doc_lens, (0, grow))
        ids, lens = self._doc_token_rows(list(texts))
        if lens.size:
            self._max_doc_len = max(self._max_doc_len, int(lens.max()))
        n = len(lens)
        self._doc_tokens[start : start + n] = torch.from_numpy(ids).to(self.device)
        self._doc_lens[start : start + n] = torch.from_numpy(lens).to(self.device)

    def remove(self, keys: list) -> None:
        """Remove documents, keeping the token store aligned with the
        index's swap-with-last slot moves (in place)."""
        for key in keys:
            slot = self.index._slot_of.get(key)
            if slot is None:
                continue
            last = self.index.n - 1
            if slot != last:
                self._doc_tokens[slot] = self._doc_tokens[last]
                self._doc_lens[slot] = self._doc_lens[last]
            self._doc_lens[last] = 0
            self.index.remove([key])

    # ------------------------------------------------------------ queries
    def _tokenize_queries(self, texts: list[str], max_length: int | None = None):
        """Tokenize + bucket-pad queries. Returns device tensors plus the
        true max query length (read from the host mask)."""
        m = self.embedder
        ids, mask = m.tokenizer(texts, max_length=max_length or m.max_length)
        q_max = int(mask.sum(axis=1).max()) if mask.size else 2
        ids, mask = pad_to_buckets(ids, mask, row_lo=1)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), q_max)

    def _pair_bucket(self, q_max: int) -> int:
        """Pair width for this query batch: the pow2 bucket of the longest
        real pair ``q_len + max_doc_len + 1``, capped at ``pair_seq`` (or
        ``pair_seq`` itself without ``pair_buckets``)."""
        if not self.pair_buckets:
            return self.pair_seq
        need = q_max + min(self._max_doc_len, self.doc_seq) + 1
        return min(self.pair_seq, next_pow2(need, 16))

    def retrieve_device(self, texts: list[str], k: int):
        """(scores (Qb, k), idx (Qb, k)) on the device; Qb is the row bucket."""
        ids, mask, _ = self._tokenize_queries(texts)
        e = self.embedder
        record_device_dispatch("fused_retrieve")
        emb = embed_fn(e.params, ids, mask, e.cfg)
        return search_corpus(
            self.index._corpus, self.index._valid, emb,
            min(k, self.index.capacity), self.metric,
            f32_scores=self.index.f32_scores,
        )

    def retrieve(self, texts: list[str], k: int):
        """[(key, score)] per query, best first."""
        scores, idx = self.retrieve_device(texts, k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        record_retrieval_backend("dense", len(texts))
        return self.index.resolve(scores, idx, len(texts), k)

    def _cascade_plan(self, k: int):
        """(depth, survivors, seed_weight) of a cascade over k candidates:
        the attributes, or half the reranker's depth and half the
        candidates (at least 8) where they are 0."""
        layers = self.reranker.cfg.layers
        depth = self.rerank_cascade_depth or max(1, layers // 2)
        depth = max(1, min(depth, layers))
        keep = self.rerank_cascade_survivors or max(8, k // 2)
        keep = max(1, min(keep, k))
        return depth, keep, float(self.rerank_seed_weight)

    def _record_cascade(self, qb: int, k: int, keep: int, depth: int,
                        pair_seq: int) -> None:
        r_cfg = self.reranker.cfg
        record_cascade("cheap", qb * k, _encoder_flops(r_cfg, pair_seq, depth, qb * k))
        record_cascade("full", qb * keep,
                       _encoder_flops(r_cfg, pair_seq, r_cfg.layers, qb * keep))

    def _rerank(self, texts: list[str], k: int):
        if self.reranker is None:
            raise ValueError("construct FusedRAGPipeline with a reranker")
        ids, mask, q_max = self._tokenize_queries(
            texts,
            max_length=min(self.embedder.max_length, self._rerank_q_budget),
        )
        e, r = self.embedder, self.reranker
        k_eff, pair_seq = min(k, self.index.capacity), self._pair_bucket(q_max)
        args = (e.params, ids, mask, self.index._corpus, self.index._valid,
                self._doc_tokens, self._doc_lens, r.params, r.head, e.cfg, r.cfg,
                k_eff, self.metric, pair_seq)
        if self.rerank_cascade:
            depth, keep, seed_w = self._cascade_plan(k_eff)
            record_device_dispatch("fused_rerank_cascade")
            self._record_cascade(len(texts), k_eff, keep, depth, pair_seq)
            return _retrieve_rerank_cascade(*args, depth, keep, seed_w)
        record_device_dispatch("fused_retrieve_rerank")
        return _retrieve_rerank(*args)

    def retrieve_rerank_device(self, text: str, k: int):
        """One query: (knn_scores (k,), idx (k,), rerank_scores (k,),
        order (k,)) on the device."""
        return tuple(t[0] for t in self._rerank([text], k))

    def retrieve_rerank(self, text: str, k: int):
        """[(key, rerank_score)] best-first for one query."""
        out = [t.cpu().numpy() for t in self.retrieve_rerank_device(text, k)]
        return self._resolve_rerank_row(*out)

    def retrieve_rerank_batch_device(self, texts: list[str], k: int):
        """Batched retrieve + rerank: (knn_scores, idx, rerank_scores,
        order), each (Qb, k) with Qb the pow2 row bucket — callers slice
        ``[:len(texts)]``."""
        return self._rerank(texts, k)

    def retrieve_rerank_batch(self, texts: list[str], k: int):
        """Per-query [(key, rerank_score)] best-first lists."""
        scores, idx, r_scores, order = (
            t.cpu().numpy() for t in self.retrieve_rerank_batch_device(texts, k)
        )
        return [
            self._resolve_rerank_row(scores[i], idx[i], r_scores[i], order[i])
            for i in range(len(texts))
        ]

    def _resolve_rerank_row(self, scores, idx, r_scores, order):
        out = []
        for j in order:
            if scores[j] <= _NEG_INF / 2:
                continue
            slot = int(idx[j])
            if slot < len(self.index._keys):
                out.append((self.index._keys[slot], float(r_scores[j])))
        return out
