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
cross-encoder.

With ``late_interaction`` as well (off by default, as JAX's flag) the
cheap stage is MaxSim over an ingest-time doc-token bank
(``ops/late_bank.py``): every document's token states, projected to
``late_dim`` dims and stored int8 beside the corpus, slot for slot. The
query encodes once; its pooled embedding retrieves and its projected
tokens score the candidates' bank rows, with no encoder pass a candidate.
The bank is allocated at first use, grows with the index, follows its
swap-with-last removals, and backfills rows ingested while the flag was
off at the next MaxSim query. Its live bytes are the ``late_bank``
component of the HBM ledger.

An optional listwise LLM stage (``llm_reranker`` with ``llm_rerank``, off
by default) reorders each resolved rerank row on the host, every document
keeping its cross-encoder score. The sharded (mesh) branch of the JAX
pipeline is not part of the port yet. Each query counts its device
dispatch (``fused_retrieve`` / ``fused_retrieve_rerank`` /
``fused_rerank_cascade`` / ``fused_rerank_maxsim``) and ``retrieve`` the
queries its dense index answered, as in JAX (``engine/probes.py``); the
cascade charges its stages' pairs and FLOPs to the cascade ledger.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.engine.probes import (
    drop_hbm_owner,
    drop_hbm_owner_at_collect,
    record_cascade,
    record_device_dispatch,
    record_hbm,
    record_retrieval_backend,
)
from pathway_tpu_torch.models.cross_encoder import score_fn
from pathway_tpu_torch.models.decoder import _device_key
from pathway_tpu_torch.models.embedder import embed_fn, mean_pool
from pathway_tpu_torch.models.tokenizer import PAD_ID, SEP_ID, pad_to_buckets
from pathway_tpu_torch.models.transformer import TransformerConfig, encode
from pathway_tpu_torch.ops import next_pow2
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, search_corpus, topk_scores
from pathway_tpu_torch.ops.late_bank import (
    LATE_DIM,
    doc_token_states,
    maxsim_flops,
    maxsim_scores,
    projection_flops,
    query_token_states,
)
from pathway_tpu_torch.parallel.mesh import Mesh, make_mesh
from pathway_tpu_torch.parallel.sharded_ivf import ShardedIvfIndex

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
    return (scores, idx) + _cascade_finish(
        scores, cheap, pair, mask, ttype, r_params, r_head, r_cfg, k, pair_seq,
        keep, seed_weight)


def _cascade_finish(scores, cheap, pair, mask, ttype, r_params, r_head,
                    r_cfg: TransformerConfig, k: int, pair_seq: int, keep: int,
                    seed_weight: float):
    """The shared back half of both cascades, from the cheap stage's (Qb,
    k) scores: seed them with the retrieval score, keep the top ``keep``,
    cross-encode the survivors at full depth, and order survivors first.
    Returns (rerank_scores, order), each (Qb, k)."""
    qb = cheap.shape[0]
    # seed with the ranking signal retrieval already paid for
    cheap = cheap + float(seed_weight) * scores.float()
    cheap = torch.where(scores <= _NEG_INF / 2, _NEG_INF, cheap)
    _, surv = topk_scores(cheap, keep)                              # (Qb, keep)

    def survivors(a):
        """The survivors' rows of a (Qb, k, P) pair input, flat."""
        rows = torch.gather(a, 1, surv[:, :, None].expand(-1, -1, pair_seq))
        return rows.reshape(qb * keep, pair_seq)

    full = _pair_scores(r_params, r_head, survivors(pair), survivors(mask),
                        survivors(ttype), r_cfg).reshape(qb, keep)
    full = torch.where(torch.gather(scores, 1, surv) <= _NEG_INF / 2, _NEG_INF, full)
    r_scores = cheap.scatter(1, surv, full)
    surv_sorted = torch.gather(surv, 1, torch.argsort(-full, dim=1, stable=True))
    # survivor slots drop to -inf, strictly below the _NEG_INF of padded
    # candidates: otherwise (live docs < keep) they tie, the sort takes
    # survivors again and ``order`` stops being a permutation
    rest = cheap.scatter(1, surv, torch.full_like(full, float("-inf")))
    rest_order = torch.argsort(-rest, dim=1, stable=True)
    order = torch.cat([surv_sorted, rest_order[:, : k - keep]], dim=1)
    return r_scores, order


def _retrieve_maxsim_cascade(e_params, q_ids, q_mask, corpus, valid, doc_tokens,
                             doc_lens, bank_q, bank_scale, late_proj, r_params,
                             r_head, e_cfg: TransformerConfig,
                             r_cfg: TransformerConfig, k: int, metric: str,
                             pair_seq: int, keep: int, seed_weight: float):
    """The late-interaction cascade: the cheap stage is MaxSim over the
    candidates' bank rows, one (S, dc) x (dc, T) product a candidate and
    no encoder pass. The query encodes once: its token states give both
    the pooled retrieval embedding and the projected query tokens.
    Survivor selection, the full-depth pass and the order are those of
    :func:`_retrieve_rerank_cascade`.

    Returns (knn_scores, idx, rerank_scores, order), each (Qb, k)."""
    hidden = encode(e_params, q_ids, q_mask, e_cfg)                 # (Qb, S, H)
    pooled = mean_pool(hidden, q_mask)
    emb = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    scores, idx = search_corpus(corpus, valid, emb, k, metric)      # (Qb, k)
    d_len = doc_lens[idx]                                            # (Qb, k)
    q_len = q_mask.sum(dim=1).to(torch.int32)
    pair, mask, ttype = _assemble_pairs(q_ids, q_len, doc_tokens[idx], d_len, pair_seq)
    q_tok = query_token_states(hidden, q_mask, late_proj)           # (Qb, S, dc)
    cheap = maxsim_scores(q_tok, q_mask, bank_q[idx], bank_scale[idx], d_len)
    return (scores, idx) + _cascade_finish(
        scores, cheap, pair, mask, ttype, r_params, r_head, r_cfg, k, pair_seq,
        keep, seed_weight)


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
    change between calls, as JAX reads its flags. ``late_interaction``
    (read per call) makes the cascade's cheap stage MaxSim over the
    doc-token bank, whose width ``late_dim`` is read once, at the bank's
    first allocation; its projection is the embedder's
    (``late_projection_matrix``), so bank rows built here and through
    ``token_bank_submit`` agree. ``close()`` drops the bank and its ledger
    entry (a later late query builds it again). ``llm_reranker`` (a :class:`ListwiseLLMReranker`)
    with ``llm_rerank`` (read per call) reorders every resolved rerank row.
    ``mesh_retrieval`` (JAX's ``PATHWAY_TPU_MESH`` for retrieval; ``True``:
    a ``dp`` mesh over every visible CUDA device, or the embedder's device
    on the CPU; or a ``parallel.Mesh``) mirrors the corpus into a
    ``ShardedIvfIndex`` probing all 16 cells of each shard, and plain
    ``retrieve`` (so ``QueryServer`` retrieval) answers from it; rerank
    keeps the dense path. Every default is the JAX flag default."""

    def __init__(self, embedder, reranker=None, *,
                 reserved_space: int = 1024, metric: str = "cos",
                 doc_seq: int = 96, pair_seq: int = 160,
                 pair_buckets: bool = True, rerank_cascade: bool = False,
                 rerank_cascade_depth: int = 0,
                 rerank_cascade_survivors: int = 0,
                 rerank_seed_weight: float = 0.25,
                 late_interaction: bool = False, late_dim: int = LATE_DIM,
                 llm_reranker=None, llm_rerank: bool = False,
                 mesh_retrieval=False):
        self.embedder = embedder          # SentenceEmbedderModel
        self.reranker = reranker          # CrossEncoderModel | None
        # the listwise LLM final stage; doc texts are kept on the host for
        # its prompts only when it is attached
        self.llm_reranker = llm_reranker  # ListwiseLLMReranker | None
        self.llm_rerank = llm_rerank
        self._text_by_key: dict = {}
        self.late_interaction = late_interaction
        self.late_dim = late_dim
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
        # the mesh-resident mirror: exhaustive probing keeps recall at 1.0,
        # the split is over shards, not cells
        self.sharded_index = None
        if mesh_retrieval:
            mesh = mesh_retrieval
            if not isinstance(mesh, Mesh):
                devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                        if self.device.type == "cuda" else [self.device])
                mesh = make_mesh(devs, dp=len(devs), tp=1)
            self.sharded_index = ShardedIvfIndex(
                mesh, dimensions=embedder.cfg.hidden, n_cells=16, nprobe=16,
                metric="l2" if metric in ("l2", "l2sq") else "cos")
        cap = self.index.capacity
        self._doc_tokens = torch.zeros((cap, doc_seq), dtype=torch.int32,
                                       device=self.device)
        self._doc_lens = torch.zeros((cap,), dtype=torch.int32,
                                     device=self.device)
        # longest stored doc-token row, tracked on the host so the pair
        # bucket needs no device round trip; never lowered on remove, so it
        # stays a safe upper bound
        self._max_doc_len = 0
        # the late-interaction bank: int8 token states and f32 scales on the
        # device, slot-aligned with the corpus, allocated at the first add
        # or query with late_interaction on (a pipeline without it holds
        # none). `_bank_valid` (host) marks the slots whose row is current,
        # so rows ingested with the flag off backfill at query time.
        self._bank_q = None       # (cap, doc_seq, dc) int8
        self._bank_scale = None   # (cap, doc_seq, 1) f32
        self._bank_valid = None   # (cap,) bool, host
        self._late_proj = None    # (H, dc) f32, shared by ingest and query
        self._late_dim = 0
        # the HBM ledger's owner of the bank's bytes (dropped by close() or
        # at the pipeline's collection)
        self.hbm_owner = f"rag:{id(self):x}"
        drop_hbm_owner_at_collect(self, self.hbm_owner)

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
        if self.llm_reranker is not None:
            self._text_by_key.update(zip(keys, texts))
        if lens.size:
            self._max_doc_len = max(self._max_doc_len, int(lens.max()))
        n = len(lens)
        self._doc_tokens[start : start + n] = torch.from_numpy(ids).to(self.device)
        self._doc_lens[start : start + n] = torch.from_numpy(lens).to(self.device)
        if self.late_interaction or self._bank_q is not None:
            self._late_alloc()
            if self.late_interaction:
                # the ingest-time bank build: one full-depth encode a batch
                bq, bs = self._late_bank_rows(ids, lens)
                self._bank_q[start : start + n] = bq
                self._bank_scale[start : start + n] = bs
                self._bank_valid[start : start + n] = True
            else:
                # the flag went off: these rows backfill at the next MaxSim query
                self._bank_valid[start : start + n] = False
            self._record_late_bank()
        if self.sharded_index is not None:
            # mirror the embedded rows by slot (an upsert may have moved rows)
            slots = torch.as_tensor([self.index._slot_of[key] for key in keys],
                                    device=self.device)
            self.sharded_index.add(list(keys), self.index._corpus[slots].float().cpu().numpy())

    def remove(self, keys: list) -> None:
        """Remove documents, keeping the token store and the bank aligned
        with the index's swap-with-last slot moves (in place). Use this,
        not ``index.remove``: the raw index call would leave another
        document's tokens and bank row in the vacated slot."""
        for key in keys:
            slot = self.index._slot_of.get(key)
            if slot is None:
                continue
            last = self.index.n - 1
            if slot != last:
                self._doc_tokens[slot] = self._doc_tokens[last]
                self._doc_lens[slot] = self._doc_lens[last]
            self._doc_lens[last] = 0
            if self._bank_q is not None:
                # the bank row moves with its document; the vacated tail
                # slot loses validity (and its bytes leave the gauge)
                if slot != last:
                    self._bank_q[slot] = self._bank_q[last]
                    self._bank_scale[slot] = self._bank_scale[last]
                    self._bank_valid[slot] = self._bank_valid[last]
                self._bank_valid[last] = False
            self.index.remove([key])
            self._text_by_key.pop(key, None)
        if self._bank_q is not None:
            self._record_late_bank()
        if self.sharded_index is not None:
            self.sharded_index.remove(list(keys))

    def close(self) -> None:
        """Let the late-interaction bank go and drop this pipeline's HBM
        ledger entry. The corpus stays; a later query with
        ``late_interaction`` on allocates and backfills the bank again
        (``late_dim`` is read anew)."""
        self._bank_q = self._bank_scale = self._bank_valid = None
        self._late_proj, self._late_dim = None, 0
        drop_hbm_owner(self.hbm_owner)

    # ------------------------------------------- late-interaction bank
    def _late_alloc(self) -> None:
        """Allocate the bank (first use; ``late_dim`` freezes here) or grow
        it with the index's capacity doublings, slot-aligned with
        ``_doc_tokens``."""
        cap = self.index.capacity
        if self._bank_q is None:
            self._late_proj = self.embedder.late_projection_matrix(int(self.late_dim))
            self._late_dim = int(self._late_proj.shape[1])
            self._bank_q = torch.zeros((cap, self.doc_seq, self._late_dim),
                                       dtype=torch.int8, device=self.device)
            self._bank_scale = torch.zeros((cap, self.doc_seq, 1), dtype=torch.float32,
                                           device=self.device)
            self._bank_valid = np.zeros((cap,), dtype=bool)
            return
        if cap != self._bank_q.shape[0]:
            grow = cap - self._bank_q.shape[0]
            self._bank_q = torch.nn.functional.pad(self._bank_q, (0, 0, 0, 0, 0, grow))
            self._bank_scale = torch.nn.functional.pad(self._bank_scale,
                                                       (0, 0, 0, 0, 0, grow))
            self._bank_valid = np.pad(self._bank_valid, (0, grow))

    def _late_bank_rows(self, ids: np.ndarray, lens: np.ndarray):
        """Bank rows of a batch of tokenized docs, one encode: rows padded
        to their pow2 bucket, the width exactly ``doc_seq`` (the bank's).
        An empty doc keeps one live (pad) position, since an all-masked row
        has nothing to attend; its length 0 hides it from MaxSim."""
        rows = ids.shape[0]
        rb = next_pow2(max(rows, 1), 1)
        ids_p = np.zeros((rb, self.doc_seq), dtype=np.int32)
        ids_p[:rows] = ids
        live = np.maximum(lens, 1)
        mask_p = np.zeros((rb, self.doc_seq), dtype=np.int32)
        mask_p[:rows] = (np.arange(self.doc_seq)[None, :] < live[:, None]).astype(np.int32)
        record_device_dispatch("late_bank_build")
        bq, bs = doc_token_states(
            self.embedder.params, torch.from_numpy(ids_p).to(self.device),
            torch.from_numpy(mask_p).to(self.device), self._late_proj,
            self.embedder.cfg)
        return bq[:rows], bs[:rows]

    def _ensure_late_bank(self) -> None:
        """Backfill the rows of live slots ingested while the flag was off,
        in batches of 256, one encode each. After this every live slot's
        row is current."""
        self._late_alloc()
        missing = np.flatnonzero(~self._bank_valid[: self.index.n])
        if not missing.size:
            return
        for i in range(0, missing.size, 256):
            sl = missing[i : i + 256]
            dev_sl = torch.from_numpy(sl).to(self.device)
            bq, bs = self._late_bank_rows(self._doc_tokens[dev_sl].cpu().numpy(),
                                          self._doc_lens[dev_sl].cpu().numpy())
            self._bank_q[dev_sl] = bq
            self._bank_scale[dev_sl] = bs
            self._bank_valid[sl] = True
        self._record_late_bank()

    def _record_late_bank(self) -> None:
        """The bank's live bytes (valid rows, not the allocated capacity)
        as the ``late_bank`` component of the HBM ledger, under this
        pipeline's owner: a retraction lowers the gauge."""
        cap = self._bank_q.shape[0]
        live = int(self._bank_valid.sum())
        nb = sum(t.numel() * t.element_size() for t in (self._bank_q, self._bank_scale))
        record_hbm("late_bank", nb * live // cap if cap else 0,
                   device=_device_key(self._bank_q), owner=self.hbm_owner)

    def _record_maxsim(self, qb: int, k: int, keep: int, pair_seq: int) -> None:
        """The MaxSim cascade on the cascade ledger: the per-pair
        similarity product plus the per-query projection, then the
        full-depth pass over the survivors."""
        r_cfg = self.reranker.cfg
        q_seq = min(self.embedder.max_length, self._rerank_q_budget)
        record_cascade(
            "maxsim", qb * k,
            maxsim_flops(q_seq, self.doc_seq, self._late_dim, qb * k)
            + projection_flops(q_seq, self.embedder.cfg.hidden, self._late_dim, qb))
        record_cascade("full", qb * keep,
                       _encoder_flops(r_cfg, pair_seq, r_cfg.layers, qb * keep))

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
        """[(key, score)] per query, best first (from the sharded mirror
        under ``mesh_retrieval``: the query embed, then one sharded IVF
        search)."""
        if self.sharded_index is not None:
            ids, mask, _ = self._tokenize_queries(texts)
            record_device_dispatch("sharded_ivf_search")
            e = self.embedder
            emb = embed_fn(e.params, ids, mask, e.cfg).float().cpu().numpy()[:len(texts)]
            return self.sharded_index.search(emb, k)
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
            if self.late_interaction:
                record_device_dispatch("fused_rerank_maxsim")
                self._ensure_late_bank()
                self._record_maxsim(len(texts), k_eff, keep, pair_seq)
                return _retrieve_maxsim_cascade(
                    *args[:7], self._bank_q, self._bank_scale, self._late_proj,
                    *args[7:], keep, seed_w)
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
        return self._llm_rerank_rows([text], [self._resolve_rerank_row(*out)])[0]

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
        rows = [
            self._resolve_rerank_row(scores[i], idx[i], r_scores[i], order[i])
            for i in range(len(texts))
        ]
        return self._llm_rerank_rows(texts, rows)

    def _llm_rerank_rows(self, texts: list[str], rows: list[list]):
        """The optional listwise LLM final stage over resolved rows. Each
        row is ``[(key, score)]`` best-first from the cross-encoder; the
        LLM permutes the order and every document keeps its cross-encoder
        score (the listwise pass ranks, it does not score). A no-op unless
        a reranker is attached and ``llm_rerank`` is on."""
        if self.llm_reranker is None or not self.llm_rerank:
            return rows
        docs_lists = [[self._text_by_key.get(key, "") for key, _ in row] for row in rows]
        record_cascade("llm_rerank", sum(len(r) for r in rows))
        perms = self.llm_reranker.rerank_batch(list(texts), docs_lists)
        return [[row[j] for j in perm] for row, perm in zip(rows, perms)]

    def _resolve_rerank_row(self, scores, idx, r_scores, order):
        out = []
        for j in order:
            if scores[j] <= _NEG_INF / 2:
                continue
            slot = int(idx[j])
            if slot < len(self.index._keys):
                out.append((self.index._keys[slot], float(r_scores[j])))
        return out
