"""The answer LLM of the port: ``DecoderChat`` and its continuous-batching
server (counterparts of ``TPUDecoderChat`` and ``_ContinuousServer`` in
``pathway_tpu/xpacks/llm/llms.py``).

``DecoderChat`` has the JAX chat's constructor and call surface but is a
plain class: the Pathway UDF engine is not ported. It generates either
batch-static (``decoder.generate``, one call per batch of prompts) or, with
``continuous=True``, through ``_ContinuousServer``: a background thread that
owns a slot pool (dense, or paged with a block table), admits requests into
free slots at chunk boundaries, prefills long prompts piece by piece
interleaved with decode chunks, runs ``pipeline_depth`` chunks ahead of the
token drain, and frees a slot as soon as its dispatched steps cover its
budget.

The server carries the JAX server's prefix KV cache, on by default as in
JAX: a host radix tree (``engine/prefix_cache.py``) over block-aligned
prompt prefixes whose KV stays on the card, in an arena beside a dense pool
or as shared copy-on-write blocks of a paged pool, so a request whose
prompt head is cached prefills only its suffix; with ``prefix_t2_mb > 0``
evicted prefixes demote to host RAM and come back by asynchronous
promotion.

Greedy servers decode speculatively by default, as in JAX: the first
layers of the model draft a few tokens, one full-model pass verifies them
all, and the longest agreeing prefix is accepted (the same tokens as plain
greedy decode); a latch falls back to plain chunks for good when the
acceptance rate stays low. Chunk-steps autotune, also on by default,
shrinks the decode chunk under queue pressure and sizes it against the
observed arrival gap.

Behaviour is set by constructor arguments whose defaults are the JAX flag
defaults, for every feature the server carries. The JAX server's
disaggregated lanes, tenant scheduling and serving mesh are not ported;
asking for any of them raises ``NotImplementedError`` (their defaults here
are off). Nothing reads an environment variable.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device, to_device
from pathway_tpu_torch.engine.async_runtime import StageWorker
from pathway_tpu_torch.engine.prefix_cache import PrefixCache
from pathway_tpu_torch.engine.probes import (
    record_prefix,
    record_spec,
    record_spec_many,
    record_stage,
)
from pathway_tpu_torch.models import decoder as D
from pathway_tpu_torch.ops import next_pow2

# Serving failures travel the string response channel as a reserved-prefix
# marker (the \x00 prefix cannot appear in decoded model output).
SERVE_ERROR_MARKER = "\x00pathway_tpu:serve_error\x00"


def encode_serve_error(reason: str) -> str:
    return SERVE_ERROR_MARKER + json.dumps({"reason": reason})


def _parse_quant(raw) -> str:
    """``int8`` (or any truthy spelling, or True) enables int8; anything
    else is full precision."""
    if raw is True:
        return "int8"
    if raw in (False, None):
        return ""
    return "int8" if str(raw).strip().lower() in ("1", "true", "yes", "on", "int8") else ""


def _messages_to_list(messages) -> list[dict]:
    if isinstance(messages, str):
        return [{"role": "user", "content": messages}]
    return [dict(m) for m in messages]


class DecoderChat:
    """Local GPT-2-family chat generating on the card.

    Construct from ``checkpoint_path`` (a local HF GPT-2-family directory:
    ``config.json``, weights, and ``vocab.json`` / ``merges.txt`` unless a
    ``tokenizer`` is given), or from explicit ``params`` (the port's param
    dict, any device) + ``cfg`` + ``tokenizer`` (``encode``/``decode`` and
    an ``eos_id``).
    Calls take a list of messages (each a string or a list of
    ``{"role", "content"}`` dicts) and return one completion string each.
    ``device=None`` runs on CUDA and raises without it; ``device="cpu"``
    runs the plain PyTorch path."""

    def __init__(
        self,
        checkpoint_path: str | None = None,
        params: dict | None = None,
        cfg=None,
        tokenizer=None,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        max_prompt_tokens: int = 512,
        seed: int = 0,
        continuous: bool = False,
        n_slots: int = 16,
        chunk_steps: int = 16,
        pipeline_depth: int = 4,
        chunked_prefill: bool | None = None,
        prefill_chunk: int | None = None,
        eager_refill: bool | None = None,
        prefix_cache: bool | None = None,
        prefix_cache_mb: float | None = None,
        prefix_block: int | None = None,
        spec_decode: bool | None = None,
        spec_draft_layers: int | None = None,
        spec_k: int | None = None,
        chunk_autotune: bool | None = None,
        kv_quant: str | bool | None = None,
        paged_kv: bool | None = None,
        paged_kv_block: int | None = None,
        paged_kv_blocks: int | None = None,
        paged_kernel: bool | None = None,
        flash_prefill: bool | None = None,
        disagg: bool | None = None,
        disagg_prefill_budget: int | None = None,
        tenant_sched: bool | None = None,
        tenant_budget: int | None = None,
        tenant_weights: str | None = None,
        prefix_t2_mb: float | None = None,
        mesh=None,
        weight_quant: str | bool | None = None,
        wq_kernel: bool | None = None,
        device=None,
    ):
        if checkpoint_path is not None:
            from pathway_tpu_torch.models.bpe import BPETokenizer
            from pathway_tpu_torch.models.checkpoint import load_decoder_checkpoint
            from pathway_tpu_torch.models.params import from_jax_params

            np_params, cfg = load_decoder_checkpoint(checkpoint_path, cfg)
            params = from_jax_params(np_params)
            if tokenizer is None:
                tokenizer = BPETokenizer.from_dir(checkpoint_path)
        if params is None or cfg is None or tokenizer is None:
            raise ValueError(
                "DecoderChat needs checkpoint_path or params + cfg + tokenizer")
        self.device = resolve_device(device)
        self.weight_quant = _parse_quant(weight_quant)
        self.wq_kernel = bool(self.weight_quant) and bool(wq_kernel)
        if self.wq_kernel:
            cfg = dataclasses.replace(cfg, wq_kernel=True)
        params = D.map_params(lambda t: t.to(self.device), params)
        if self.weight_quant:
            self.params = D.quantize_params(params, cfg)
        else:
            self.params = D.cast_params_for_inference(params, cfg)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.max_prompt_tokens = min(int(max_prompt_tokens),
                                     cfg.max_position - self.max_new_tokens)
        if self.max_prompt_tokens <= 0:
            raise ValueError(
                f"max_new_tokens ({self.max_new_tokens}) leaves no room for a "
                f"prompt within max_position ({cfg.max_position})"
            )
        self._seed = int(seed)
        self._calls = 0
        self._server: _ContinuousServer | None = None
        if continuous:
            self._server = _ContinuousServer(
                self.params, cfg, tokenizer,
                n_slots=n_slots, chunk_steps=chunk_steps,
                max_prompt_tokens=self.max_prompt_tokens,
                default_max_new=self.max_new_tokens,
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, seed=seed,
                pipeline_depth=pipeline_depth,
                chunked_prefill=chunked_prefill,
                prefill_chunk=prefill_chunk,
                eager_refill=eager_refill,
                prefix_cache=prefix_cache,
                prefix_cache_mb=prefix_cache_mb,
                prefix_block=prefix_block,
                spec_decode=spec_decode,
                spec_draft_layers=spec_draft_layers,
                spec_k=spec_k,
                chunk_autotune=chunk_autotune,
                kv_quant=kv_quant,
                paged_kv=paged_kv,
                paged_kv_block=paged_kv_block,
                paged_kv_blocks=paged_kv_blocks,
                paged_kernel=paged_kernel,
                flash_prefill=flash_prefill,
                disagg=disagg,
                disagg_prefill_budget=disagg_prefill_budget,
                tenant_sched=tenant_sched,
                tenant_budget=tenant_budget,
                tenant_weights=tenant_weights,
                prefix_t2_mb=prefix_t2_mb,
                mesh=mesh,
            )

    @property
    def server(self) -> "_ContinuousServer | None":
        return self._server

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()

    def _format_prompt(self, messages) -> str:
        if isinstance(messages, str):
            return messages
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in _messages_to_list(messages)]
        return "\n".join(parts) + "\nassistant:"

    def _prompt_cap(self, max_new: int) -> int:
        cap = min(self.max_prompt_tokens, self.cfg.max_position - max_new)
        if cap <= 0:
            raise ValueError(
                f"max_new_tokens ({max_new}) leaves no room for a prompt "
                f"within max_position ({self.cfg.max_position})"
            )
        return cap

    # two-phase protocol (continuous mode): submit enqueues every row
    # without waiting; resolve blocks on the completions
    def submit_batch(self, messages: list, **kwargs):
        if self._server is None:
            raise TypeError("submit_batch requires continuous=True")
        max_new = int(kwargs.pop("max_new_tokens", self.max_new_tokens))
        # priority and tenant only steer the degradation ladder and the
        # tenant scheduler, neither of which is ported
        kwargs.pop("priority", None)
        kwargs.pop("tenant", None)
        if kwargs:
            raise TypeError(
                f"continuous DecoderChat cannot vary {sorted(kwargs)} per "
                f"call; set them on the constructor"
            )
        if max_new > self.max_new_tokens:
            raise ValueError(
                f"continuous DecoderChat serves at most the constructor's "
                f"max_new_tokens ({self.max_new_tokens}) per request; got {max_new}"
            )
        cap = self._prompt_cap(max_new)
        return [self._server.submit(
            self.tokenizer.encode(self._format_prompt(m))[-cap:], max_new)
            for m in messages]

    def resolve_batch(self, handles) -> list:
        out = []
        for reqs in handles:
            texts = []
            for req in reqs:
                req.done.wait()
                if req.text is None:
                    texts.append(encode_serve_error(req.error_reason or "serve_failed"))
                else:
                    texts.append(req.text)
            out.append(texts)
        return out

    def __call__(self, messages: list, **kwargs) -> list[str | None]:
        if self._server is not None:
            return self.resolve_batch([self.submit_batch(messages, **kwargs)])[0]
        max_new = int(kwargs.pop("max_new_tokens", self.max_new_tokens))
        temp = float(kwargs.pop("temperature", self.temperature))
        top_k = kwargs.pop("top_k", self.top_k)
        # clamp into [1, vocab_size], as HF does
        top_k = None if top_k is None else min(max(1, int(top_k)), self.cfg.vocab_size)
        top_p = kwargs.pop("top_p", self.top_p)
        top_p = None if top_p is None else float(top_p)
        if kwargs:
            raise TypeError(f"DecoderChat got unsupported call kwargs: {sorted(kwargs)}")
        cap = self._prompt_cap(max_new)
        encoded = [self.tokenizer.encode(self._format_prompt(m))[-cap:]
                   for m in messages]
        s = min(next_pow2(max((len(e) for e in encoded), default=1), 8), cap)
        rows = next_pow2(len(encoded), 1)
        ids = np.zeros((rows, s), np.int32)
        mask = np.zeros((rows, s), np.int32)
        for r, e in enumerate(encoded):  # LEFT-padded (decoder contract)
            e = e[-s:]
            if e:
                ids[r, s - len(e):] = e
                mask[r, s - len(e):] = 1
            else:
                mask[r, -1] = 1  # empty prompt: one live pad slot
        # a new draw per call: sampling must not replay one fixed draw
        self._calls += 1
        gen = torch.Generator(device=self.device).manual_seed(
            self._seed * 1_000_003 + self._calls)
        eos = getattr(self.tokenizer, "eos_id", None)
        toks = D.generate(
            self.params, to_device(ids, self.device), to_device(mask, self.device),
            self.cfg, max_new, temperature=temp, generator=gen, eos_id=eos,
            top_k=top_k, top_p=top_p,
        ).cpu().numpy()
        out: list[str | None] = []
        for r in range(len(encoded)):
            t = toks[r].tolist()
            if eos is not None and eos in t:
                t = t[: t.index(eos)]
            out.append(self.tokenizer.decode(t))
        return out


class _PendingCompletion:
    """One in-flight continuous-batching request (host-side record)."""

    __slots__ = ("ids", "max_new", "tokens", "done", "text", "submitted_at",
                 "finished_at", "first_token_at", "error_reason")

    def __init__(self, ids: list, max_new: int):
        self.ids = ids
        self.max_new = max_new
        self.tokens: list[int] = []
        self.done = threading.Event()
        self.text: str | None = None
        self.submitted_at = time.perf_counter()
        self.finished_at: float | None = None
        self.first_token_at: float | None = None  # first token DRAINED
        self.error_reason: str | None = None


_UNPORTED = (
    # (argument, asked-for test, what it is)
    ("disagg", lambda v: bool(v), "disaggregated prefill/decode lanes"),
    ("tenant_sched", lambda v: bool(v), "tenant scheduling and preemption"),
    ("mesh", lambda v: v is not None, "the serving mesh"),
)


class _ContinuousServer:
    """Slot-pool serving loop for ``DecoderChat(continuous=True)``.

    A background thread owns the pool. Each loop tick dispatches the active
    lanes' decode chunk FIRST (prefill/decode overlap), then admits waiting
    requests into free slots: a dense pool prefills a short prompt whole
    (same-bucket arrivals batched into one ``pool_admit_batch``) and a long
    one in ``prefill_chunk`` pieces, one piece per tick; a paged pool
    allocates exactly the blocks a request can reach and always admits
    right-padded, piece by piece. With the prefix cache, admission first
    matches the prompt's cached head: a dense hit copies arena blocks into
    the slot's row, a paged hit shares the cached blocks through the table
    row, and either prefills only the suffix, right-padded; a finished
    prompt's full blocks are published into the tree. Up to
    ``pipeline_depth`` chunks run ahead of the token drain (each chunk's tokens copy to the host as soon as it
    is queued), and eager refill frees a lane whose dispatched steps cover
    its budget at dispatch time. A stream ends at EOS or at its own
    ``max_new``.

    A greedy server (temperature 0, no top-k / top-p, at least 2 layers)
    dispatches ``pool_decode_spec`` cycles instead of plain chunks until
    its acceptance latch trips; a chunk of ``steps`` plain steps becomes
    ``steps // (spec_k + 1)`` cycles, and eager refill counts cycles (each
    emits at least one token). Chunk autotune picks each dispatch's steps
    from the halvings of ``chunk_steps`` down to 4."""

    def __init__(self, params, cfg, tokenizer, *, n_slots: int,
                 chunk_steps: int, max_prompt_tokens: int,
                 default_max_new: int, temperature: float, top_k, top_p,
                 seed: int, pipeline_depth: int = 4,
                 chunked_prefill: bool | None = None,
                 prefill_chunk: int | None = None,
                 eager_refill: bool | None = None,
                 prefix_cache: bool | None = None,
                 prefix_cache_mb: float | None = None,
                 prefix_block: int | None = None,
                 spec_decode: bool | None = None,
                 spec_draft_layers: int | None = None,
                 spec_k: int | None = None,
                 kv_quant: str | bool | None = None,
                 paged_kv: bool | None = None,
                 paged_kv_block: int | None = None,
                 paged_kv_blocks: int | None = None,
                 paged_kernel: bool | None = None,
                 flash_prefill: bool | None = None,
                 disagg: bool | None = None,
                 disagg_prefill_budget: int | None = None,
                 tenant_sched: bool | None = None,
                 tenant_budget: int | None = None,
                 tenant_weights: str | None = None,
                 prefix_t2_mb: float | None = None,
                 mesh=None,
                 chunk_autotune: bool | None = None):
        asked = dict(disagg=disagg, tenant_sched=tenant_sched, mesh=mesh)
        for name, on, what in _UNPORTED:
            if on(asked[name]):
                raise NotImplementedError(
                    f"{name}: {what} is not ported to pathway_tpu_torch yet")
        self.cfg = cfg
        self.params = params
        self.device = params["wte"].device
        self.tokenizer = tokenizer
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.max_prompt_bucket = next_pow2(max_prompt_tokens, 8)
        # self-speculative decode: greedy only (acceptance compares
        # argmaxes), and a 1-layer model has no shallower draft stack, so
        # either takes the plain chunk path
        want_spec = True if spec_decode is None else bool(spec_decode)
        self.spec_decode = bool(want_spec and float(temperature) == 0.0
                                and top_k is None and top_p is None
                                and cfg.layers >= 2)
        d = 0 if spec_draft_layers is None else int(spec_draft_layers)
        if d <= 0:
            d = max(1, cfg.layers // 4)
        self.spec_draft_layers = max(1, min(d, cfg.layers - 1))
        self.spec_k = max(1, 3 if spec_k is None else int(spec_k))
        # the acceptance latch: after 4 drains with drafts and the
        # acceptance EMA below 0.25, plain chunks for good (same tokens)
        self._spec_off = False
        self._spec_drains = 0
        self._accept_ema: float | None = None
        self.spec_latched_at: int | None = None  # the drain that tripped it
        # spec counters between ledger flushes (loop thread only)
        self._spec_accum: dict = {}
        # a lane may overrun its budget until its tokens drain: one chunk of
        # cache slack per in-flight chunk plus the one being dispatched; a
        # spec dispatch writes up to max(chunk_steps, spec_k + 1) columns
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._slack = max(self.chunk_steps,
                          self.spec_k + 1 if self.spec_decode else 0)
        self.cache_len = (self.max_prompt_bucket + int(default_max_new)
                          + (self.pipeline_depth + 1) * self._slack)
        self.kv_quant = _parse_quant(kv_quant)
        self.eos_id = getattr(tokenizer, "eos_id", None)
        self.chunked_prefill = True if chunked_prefill is None else bool(chunked_prefill)
        self.prefill_chunk = max(8, next_pow2(
            64 if prefill_chunk is None else int(prefill_chunk), 8))
        self.eager_refill = True if eager_refill is None else bool(eager_refill)
        self.paged_kv = bool(paged_kv)
        self.paged_kernel = bool(self.paged_kv and paged_kernel)
        self.flash_prefill = bool(flash_prefill)
        self.paged_block = 0
        self._paged_blocks_override = 0
        self._allocator = None
        self._total_blocks = 0
        self._slot_blocks: dict[int, list] = {}
        if self.paged_kv:
            # a pow2 multiple of the prefill chunk; cache_len rounds up to
            # whole blocks (table rows address whole blocks)
            pb = 0 if paged_kv_block is None else int(paged_kv_block)
            self.paged_block = next_pow2(max(pb, self.prefill_chunk), self.prefill_chunk)
            self.cache_len = -(-self.cache_len // self.paged_block) * self.paged_block
            self._paged_blocks_override = max(
                0, 0 if paged_kv_blocks is None else int(paged_kv_blocks))
        # the prefix KV cache: a hit admits right-padded (token i at column
        # i, the cached blocks' layout) through the piece machinery, so the
        # cache needs chunked prefill
        self.prefix = None
        self.prefix_block = 0
        self._prefix_nodes: dict = {}  # request -> node whose path it pins
        want_prefix = True if prefix_cache is None else bool(prefix_cache)
        if want_prefix and self.chunked_prefill:
            mb = 64.0 if prefix_cache_mb is None else float(prefix_cache_mb)
            blk = 0 if prefix_block is None else int(prefix_block)
            # a pow2 multiple of the piece, so cached prefixes end on piece
            # boundaries; under paged KV a cached block is a pool block
            blk = next_pow2(max(blk, self.prefill_chunk), self.prefill_chunk)
            if self.paged_kv:
                blk = self.paged_block
            itemsize = torch.empty((), dtype=cfg.dtype).element_size()
            # int8 KV: head_dim int8 bytes plus one f32 scale a head-token
            per_tok = cfg.head_dim + 4 if self.kv_quant else cfg.head_dim * itemsize
            block_bytes = 2 * cfg.layers * cfg.heads * blk * per_tok
            n_blocks = int(mb * (1 << 20) // block_bytes)
            if n_blocks >= 1:
                self.prefix_block = blk
                self._prefix_kwargs = dict(n_blocks=n_blocks, block=blk,
                                           block_bytes=block_bytes)
                # tier 2: eviction demotes leaf edges to host RAM through
                # the export callback; budget 0 is the single-tier cache
                t2_mb = 0.0 if prefix_t2_mb is None else float(prefix_t2_mb)
                t2_blocks = int(t2_mb * (1 << 20) // block_bytes)
                if t2_blocks >= 1:
                    self._prefix_kwargs.update(tier2_blocks=t2_blocks,
                                               export=self._export_blocks)
                self.prefix = self._make_prefix_cache()
        # tier-2 promotions: a worker thread stages a hit's host blobs on
        # the card; the loop adopts them between ticks (_drain_promotions).
        # _t2_pending counts hits not yet adopted (t2_drain waits on it);
        # _t2_waiting holds requests whose last prefill piece waits for
        # their own promotion, so the promotion, not the request's own
        # insert, publishes the head
        self._promote_worker = None
        self._promote_ready: deque = deque()
        self._t2_pending = 0
        self._t2_waiting: set = set()
        self._h2d_stream = None
        if self.prefix is not None and self.prefix.tier2 is not None:
            if self.device.type == "cuda":
                self._h2d_stream = torch.cuda.Stream(self.device)
            self._promote_worker = StageWorker(self._stage_promotion, maxsize=4,
                                               name="prefix-t2-h2d")
        self.pool = self._build_pool()
        self.kv_bytes_saved = 0
        if self.kv_quant:
            # the device bytes the int8 pool does not take against the
            # same pool in the compute dtype, recorded once
            it = torch.empty((), dtype=cfg.dtype).element_size()
            base = sum(self.pool[c].numel() * it
                       for c in ("k", "v", "kb", "vb", "arena_k", "arena_v")
                       if c in self.pool)
            self.kv_bytes_saved = base - D.pool_bytes(self.pool)
            record_spec("kv_bytes_saved", self.kv_bytes_saved)
        # chunk-steps autotune: the halvings of chunk_steps down to 4, all
        # within the slack above
        self.chunk_autotune = True if chunk_autotune is None else bool(chunk_autotune)
        cands, c = [], self.chunk_steps
        while c >= 4:
            cands.append(c)
            c //= 2
        self._step_cands = cands or [self.chunk_steps]
        self._arrival_ema: float | None = None
        self._last_submit_t: float | None = None
        self._step_wall_ema: float | None = None
        self._last_dispatch_t: float | None = None
        self._last_dispatch_steps = 0
        self._temperature = float(temperature)
        self._top_k = top_k
        self._top_p = top_p
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # slot -> (remaining prefill pieces, n_prompt, meta), one piece per tick
        self._pending_prefill: dict[int, tuple] = {}
        # per-slot DISPATCHED decode steps since admission (eager refill)
        self._sent = [0] * self.n_slots
        self.queue: deque = deque()
        self.slots: list = [None] * self.n_slots
        self.free = list(range(self.n_slots))
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self._stop = False
        self.failed: BaseException | None = None
        self.stats = {"chunks": 0, "admitted": 0, "decode_steps": 0,
                      "prefill_chunks": 0, "admit_dispatches": 0,
                      "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
                      "prefix_hit_requests": 0, "prefix_requests": 0,
                      "t2_hit_requests": 0, "t2_promoted_blocks": 0,
                      "t2_dropped": 0, "spec_dispatches": 0, "spec_cycles": 0,
                      "spec_drafted": 0, "spec_accepted": 0, "spec_emitted": 0,
                      "spec_verify_steps": 0}
        # in-flight chunk records, oldest first
        self._inflight: deque = deque()
        self.thread = threading.Thread(target=self._run_safe, daemon=True,
                                       name="pathway:decoder-serve")
        self.thread.start()

    def _build_pool(self):
        """A fresh pool: ``pool_init`` with the prefix arena, or
        ``paged_pool_init`` plus a fresh host ``BlockAllocator`` (default:
        every slot's full table plus the prefix budget plus the
        sentinel)."""
        cached = self.prefix.capacity_blocks if self.prefix is not None else 0
        if self.paged_kv:
            per_slot = self.cache_len // self.paged_block
            auto = self.n_slots * per_slot + cached + 1
            self._total_blocks = max(2, self._paged_blocks_override or auto)
            self._allocator = D.BlockAllocator(self._total_blocks)
            self._slot_blocks = {}
            return D.paged_pool_init(
                self.params, self.cfg, self.n_slots, self.cache_len,
                n_blocks=self._total_blocks, block=self.paged_block,
                kv_quant=bool(self.kv_quant))
        return D.pool_init(self.params, self.cfg, self.n_slots, self.cache_len,
                           kv_quant=bool(self.kv_quant), arena_blocks=cached,
                           arena_block=self.prefix_block)

    def _make_prefix_cache(self) -> PrefixCache:
        """The prefix tree: arena-backed for a dense pool; ADOPTED for a
        paged one, whose cached ids are pool blocks held through the
        allocator's pin and release."""
        kw = dict(self._prefix_kwargs)
        if self.paged_kv:
            kw["pin"] = lambda ids: self._allocator.pin(ids)
            kw["unpin"] = lambda ids: self._allocator.release(ids)
        return PrefixCache(**kw)

    def _release_slot_kv(self, slot: int) -> None:
        """A freed paged slot's table row points at the sentinel BEFORE its
        blocks return to the allocator, so no stale row ever references a
        block that a new owner writes. On shared prefix blocks the release
        drops only the slot's own pin; the tree's pin keeps them."""
        if self._allocator is not None:
            row = self._slot_blocks.pop(slot, None)
            if row:
                M = self.cache_len // self.paged_block
                self.pool = D.paged_table_set(self.pool, slot, np.zeros((M,), np.int32))
                self._allocator.release(row)

    def _fail_request(self, req, reason: str) -> None:
        req.error_reason = reason
        req.text = None
        req.done.set()

    def _run_safe(self):
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._loop()
            else:
                self._loop()
        except BaseException as exc:  # noqa: BLE001 - never hang waiters
            self.failed = exc
        finally:
            # every request still in a slot, queued, or waiting in the
            # in-flight snapshots completes with the error sentinel
            with self.lock:
                pending = [r for r in self.slots if r is not None]
                pending.extend(self.queue)
                self.queue.clear()
            for rec in list(self._inflight):
                pending.extend(r for r in rec[2] if r is not None)
            for req in pending:
                if not req.done.is_set():
                    req.text = None
                    req.done.set()

    def submit(self, prompt_ids: list, max_new: int) -> _PendingCompletion:
        req = _PendingCompletion(list(prompt_ids), int(max_new))
        with self.lock:
            if self.failed is not None:
                raise RuntimeError(f"decoder serving loop died: {self.failed!r}")
            if self._stop:
                raise RuntimeError("decoder serving loop is shut down")
            self.queue.append(req)
            # the observed arrival gap feeds the chunk-steps autotune
            now = req.submitted_at
            if self._last_submit_t is not None:
                gap = now - self._last_submit_t
                self._arrival_ema = (gap if self._arrival_ema is None
                                     else 0.8 * self._arrival_ema + 0.2 * gap)
            self._last_submit_t = now
        self.wake.set()
        return req

    def spec_acceptance(self) -> float:
        """Drained draft-token acceptance rate (0.0 before any speculative
        dispatch drained)."""
        d = self.stats["spec_drafted"]
        return self.stats["spec_accepted"] / d if d else 0.0

    def tokens_per_dispatch(self) -> float:
        """Tokens emitted per full-model lane-cycle (the unit one plain
        decode lane-step also costs; 1.0 is the plain-decode baseline)."""
        v = self.stats["spec_verify_steps"]
        return self.stats["spec_emitted"] / v if v else 1.0

    def _pick_steps(self, queue_len: int) -> int:
        """This dispatch's decode steps. Under queue pressure the smallest
        candidate (the next chunk boundary is the next admission and slot
        release); with no queue, the largest whose wall time fits one
        observed arrival gap; with no estimate yet, the full chunk."""
        if not self.chunk_autotune or len(self._step_cands) == 1:
            return self.chunk_steps
        if queue_len > 0:
            return self._step_cands[-1]
        ia, sw = self._arrival_ema, self._step_wall_ema
        if ia is None or sw is None or sw <= 0.0:
            return self._step_cands[0]
        for c in self._step_cands:
            if c * sw <= ia:
                return c
        return self._step_cands[-1]

    def _admit_one(self, slot: int, req, direct: list) -> None:
        """Admission host work for ONE request: match its cached prefix,
        pad the prompt, and either schedule prefill pieces or queue a
        whole-prompt admission."""
        e = req.ids[-self.max_prompt_bucket:]
        n = len(e)
        if self.paged_kv:
            self._admit_one_paged(slot, req, e, n)
            return
        m_hit, arena_ids, node = self._prefix_match(req, e, n)
        if m_hit:
            # seed columns [0, m_hit * B) from the arena (a copy, no
            # compute), then prefill only the suffix, right-padded: token i
            # at column i, as the arena blocks hold it
            self.prefix.acquire(node)
            self._prefix_nodes[req] = node
            self.pool = D.pool_admit_cached(self.pool, slot, arena_ids[:m_hit])
            record_prefix("copy_bytes", m_hit * self.prefix.block_bytes)
            pieces, meta = self._right_pieces(e, n, m_hit * self.prefix_block)
            meta["insert"] = (req, e, 0)
            self._pending_prefill[slot] = (pieces, n, meta)
            self.stats["admitted"] += 1
            return
        s = max(8, next_pow2(max(n, 1), 8))
        ids = np.zeros((1, s), np.int32)
        mask = np.zeros((1, s), np.int32)
        if e:
            ids[0, s - n:] = e
            mask[0, s - n:] = 1
        else:
            mask[0, -1] = 1
        # a miss publishes its full blocks from the left-padded row, where
        # token 0 sits at column s - n
        ins = ((req, e, s - n) if self.prefix is not None and n >= self.prefix_block
               else None)
        if self.chunked_prefill and s > self.prefill_chunk:
            pos = np.clip(np.cumsum(mask[0]) - 1, 0, None)[None, :].astype(np.int32)
            P = self.prefill_chunk
            pieces = [(ids[:, o:o + P], mask[:, o:o + P], pos[:, o:o + P], o)
                      for o in range(0, s, P)]
            self._pending_prefill[slot] = (pieces, int(mask.sum()),
                                           {"insert": ins} if ins else None)
        else:
            direct.append((slot, ids, mask, s, ins))
        self.stats["admitted"] += 1

    def _prefix_match(self, req, e: list, n: int) -> tuple[int, list, object]:
        """Match prompt ``e`` against the tree and account the result;
        returns ``(m_hit, block ids, node)``. A hit never covers the final
        token: at least one suffix token goes through a prefill piece to
        produce the first-token logits. Probes tier 2 past the match."""
        if self.prefix is None or n <= self.prefix_block:
            return 0, [], None
        B = self.prefix_block
        m, ids, node = self.prefix.match(e)
        m_hit = min(m, (n - 1) // B)
        hit_t = m_hit * B
        record_prefix("requests", 1)
        record_prefix("hit_tokens", hit_t)
        record_prefix("miss_tokens", n - hit_t)
        if m_hit:
            record_prefix("hit_requests", 1)
            self.stats["prefix_hit_requests"] += 1
        self.stats["prefix_requests"] += 1
        self.stats["prefix_hit_tokens"] += hit_t
        self.stats["prefix_miss_tokens"] += n - hit_t
        # the tier-2 continuation starts at the true matched depth m
        self._t2_probe(req, e, n, m, node)
        return m_hit, ids, node

    def _right_pieces(self, e: list, n: int, n_cached: int) -> tuple[list, dict]:
        """Right-padded prefill pieces (token i at column i) over columns
        ``[n_cached, W)``, W the prompt rounded up to whole pieces; the
        meta's ``last_col`` is the final token's column in the last piece
        (None when it is the piece's last column)."""
        P = self.prefill_chunk
        W = n_cached + -((n_cached - n) // P) * P
        r_ids = np.zeros((1, W), np.int32)
        r_mask = np.zeros((1, W), np.int32)
        r_ids[0, :n] = e
        r_mask[0, :n] = 1
        pos = np.minimum(np.arange(W), n - 1)[None, :].astype(np.int32)
        pieces = [(r_ids[:, o:o + P], r_mask[:, o:o + P], pos[:, o:o + P], o)
                  for o in range(n_cached, W, P)]
        lc = (n - 1) - (W - P)
        return pieces, {"last_col": None if lc == P - 1 else lc}

    def _admit_one_paged(self, slot: int, req, e: list, n: int) -> None:
        """Paged admission: allocate exactly the blocks this request can
        reach beyond its cached head, install the slot's table row (the
        cached head's shared blocks first, copy-on-write), and schedule the
        rest of the prompt as RIGHT-padded pieces (token i at cache column
        i). On ``PagedPoolOOM`` nothing is written and the request waits at
        the queue head."""
        if not e:
            e, n = [0], 1  # one pad token at column 0
        B = self.paged_block
        per_slot = self.cache_len // B
        m_hit, pool_ids, node = self._prefix_match(req, e, n)
        # decode writes from the end of the right-padded pieces, up to P - 1
        # columns past the prompt; a column past the allocation maps to the
        # sentinel, where the paged decode would write and the gathered
        # view's scatter would drop its K/V
        P = self.prefill_chunk
        width = m_hit * B + -(-(n - m_hit * B) // P) * P
        cover = min(self.cache_len,
                    width + req.max_new + (self.pipeline_depth + 1) * self._slack)
        need = min(per_slot, -(-cover // B))
        try:
            fresh = self._allocator.alloc(need - m_hit)
        except D.PagedPoolOOM:
            self.slots[slot] = None
            with self.lock:
                self.free.append(int(slot))
            if need - m_hit > self._total_blocks - 1:
                self._fail_request(req, "paged_oom")  # can never fit
                return
            with self.lock:
                self.queue.appendleft(req)
            return
        shared = [int(i) for i in pool_ids[:m_hit]]
        if shared:
            # the slot's own pin on the shared blocks, dropped by
            # _release_slot_kv; the tree holds its own
            self._allocator.pin(shared)
        row = shared + fresh
        self._slot_blocks[slot] = row
        row_arr = np.zeros((per_slot,), np.int32)
        row_arr[:len(row)] = row
        n_cached = m_hit * B
        # one table edit installs the row and the cached columns' mask; no
        # KV bytes move, and the pieces write only past the shared run
        self.pool = D.paged_admit_cached(self.pool, slot, row_arr, n_cached)
        if m_hit:
            self.prefix.acquire(node)
            self._prefix_nodes[req] = node
        pieces, meta = self._right_pieces(e, n, n_cached)
        if self.prefix is not None and n >= B:
            meta["insert"] = (req, e, 0)
        self._pending_prefill[slot] = (pieces, n, meta)
        self.stats["admitted"] += 1

    def _prefill_piece(self, slot: int, active) -> bool:
        """Dispatch one pending prefill piece for ``slot``; False when the
        last piece is held for the request's own tier-2 promotion."""
        pieces, n_prompt, meta = self._pending_prefill[slot]
        if len(pieces) == 1 and self.slots[slot] in self._t2_waiting:
            return False
        p_ids, p_mask, p_pos, off = pieces.pop(0)
        first, last = off == 0, not pieces
        lc = meta.get("last_col") if (meta and last) else None
        dev = self.device
        self.pool = D.pool_prefill_chunk(
            self.params, to_device(p_ids, dev), to_device(p_mask, dev),
            to_device(p_pos, dev), self.pool, slot, off, n_prompt, self.cfg,
            first=first, last=last, last_col=lc, flash=self.flash_prefill)
        self.stats["prefill_chunks"] += 1
        if last:
            del self._pending_prefill[slot]
            active[slot] = True
            if meta and meta.get("insert") is not None:
                self._prefix_insert(slot, *meta["insert"])
        return True

    def _admit_direct(self, direct, active) -> None:
        """Whole-prompt admissions: same-bucket arrivals group into
        pow2-sized ``pool_admit_batch`` calls; then each admitted prompt's
        full blocks are published into the prefix tree."""
        dev = self.device
        by_s: dict[int, list] = {}
        for item in direct:
            by_s.setdefault(item[3], []).append(item)
        groups = []
        for grp in by_s.values():
            o = 0
            while o < len(grp):
                m = 1 << ((len(grp) - o).bit_length() - 1)
                groups.append(grp[o:o + m])
                o += m
        for part in groups:
            ids = to_device(np.concatenate([p[1] for p in part], axis=0), dev)
            mask = to_device(np.concatenate([p[2] for p in part], axis=0), dev)
            slots = [p[0] for p in part]
            if len(part) == 1:
                self.pool = D.pool_admit(self.params, ids, mask, self.pool,
                                         slots[0], self.cfg, flash=self.flash_prefill)
            else:
                self.pool = D.pool_admit_batch(self.params, ids, mask, self.pool,
                                               slots, self.cfg, flash=self.flash_prefill)
            self.stats["admit_dispatches"] += 1
            for slot in slots:
                active[slot] = True
        for slot, _, _, _, ins in direct:
            if ins is not None:
                self._prefix_insert(slot, *ins)

    # -- prefix cache --------------------------------------------------

    def _prefix_insert(self, slot: int, req, e: list, base: int) -> None:
        """Publish ``slot``'s freshly prefilled full blocks of prompt ``e``
        into the tree. ``base`` is the cache column of token 0 (``s - n``
        for a left-padded dense miss, 0 for right-padded rows). Moves the
        request's pin to the deepest node, so the whole prefix stays pinned
        while it decodes."""
        B = self.prefix_block
        if self.paged_kv:
            # zero-copy adoption: right-padded admission puts prompt block i
            # at row entry i, so the row is the block_ids argument
            row = self._slot_blocks.get(slot)
            if row is None:
                return
            node, _, _ = self.prefix.insert(e, n_blocks=min(len(e) // B, len(row)),
                                            block_ids=row)
        else:
            node, first_new, new_ids = self.prefix.insert(e)
            if new_ids:
                self.pool = D.kv_extract(self.pool, slot, base + first_new * B, new_ids)
        old = self._prefix_nodes.get(req)
        self.prefix.acquire(node)
        if old is not None:
            self.prefix.release(old)
        self._prefix_nodes[req] = node

    def _prefix_release(self, req) -> None:
        node = self._prefix_nodes.pop(req, None)
        if node is not None:
            self.prefix.release(node)

    def prefix_reset(self) -> None:
        """Drop every cached prefix and zero the server's prefix counters.
        Call only while no request is in flight: a paged pool's cached
        blocks unpin back to the allocator, a dense arena starts empty, and
        staged promotions are dropped with the tree they targeted."""
        if self.prefix is None:
            return
        self._prefix_nodes.clear()
        if self.paged_kv:
            self.prefix.reset()
        else:
            self.prefix = self._make_prefix_cache()
        for k in ("prefix_hit_tokens", "prefix_miss_tokens",
                  "prefix_hit_requests", "prefix_requests"):
            self.stats[k] = 0
        while True:
            try:
                req = self._promote_ready.popleft()[0]
            except IndexError:
                break
            with self.lock:
                self._t2_pending -= 1
                self._t2_waiting.discard(req)

    # -- tier-2 promotions ---------------------------------------------

    def _export_blocks(self, ids: list) -> dict:
        """Tier-2 demotion callback (``PrefixCache(export=...)``): the KV
        bytes of arena or pool blocks ``ids`` as host numpy blobs in the
        ``kv_block_export`` layout. Runs on the loop thread inside eviction
        and waits for its device-to-host copy."""
        t0 = time.perf_counter()
        blobs = {c: _host_blob(v) for c, v in D.kv_block_export(self.pool, ids).items()}
        record_stage("t2_export", time.perf_counter() - t0, len(ids))
        return blobs

    def _t2_probe(self, req, e: list, n: int, m: int, node) -> None:
        """Tier-2 lookup past a tier-1 match of ``m`` blocks. A hit
        schedules an asynchronous promotion; this request still prefills
        its head itself, and the next request on that head hits tier 1."""
        if self.prefix.tier2 is None:
            return
        n_full = (n - 1) // self.prefix_block
        if m >= n_full:
            return
        record_prefix("t2_lookups", 1)
        hit = self.prefix.match_t2(e, n_full, node, m)
        if hit is None:
            return
        keys, blobs = hit
        record_prefix("t2_hits", 1)
        self.stats["t2_hit_requests"] += 1
        with self.lock:
            self._t2_pending += 1
            self._t2_waiting.add(req)
        self._promote_worker.submit((req, list(e), int(m), list(keys), blobs))

    def _stage_promotion(self, item) -> None:
        """StageWorker fn (worker thread, total): move a hit's blobs to the
        card. On the card: pinned host copies and non-blocking copies on a
        side stream, then an event the worker waits for (so the stage time
        is the copy's) and the loop's stream waits on before reading."""
        req, tokens, j, keys, blobs = item
        try:
            t0 = time.perf_counter()
            event = None
            if self._h2d_stream is None:
                staged = {c: _device_blob(v, self.device) for c, v in blobs.items()}
            else:
                with torch.cuda.device(self.device), torch.cuda.stream(self._h2d_stream):
                    staged = {c: _device_blob(v, self.device) for c, v in blobs.items()}
                    event = torch.cuda.Event()
                    event.record(self._h2d_stream)
                event.synchronize()
            record_stage("t2_h2d", time.perf_counter() - t0, len(keys))
            self._promote_ready.append((req, tokens, j, keys, staged, event))
        except BaseException:  # noqa: BLE001 - nothing applied yet: drop the hit
            # any failure, BaseException included, releases the request: a
            # request left in _t2_waiting would hold its last piece forever
            with self.lock:
                self._t2_pending -= 1
                self._t2_waiting.discard(req)
                self.stats["t2_dropped"] += 1
        self.wake.set()

    def _drain_promotions(self) -> None:
        """Adopt every staged promotion (loop thread, once a tick, before
        admissions, so a request right behind its promotion hits tier 1)."""
        while self._promote_ready:
            req, tokens, j, keys, staged, event = self._promote_ready.popleft()
            promoted = 0
            try:
                promoted = self._apply_promotion(tokens, j, keys, staged, event)
            finally:
                with self.lock:
                    self._t2_pending -= 1
                    self._t2_waiting.discard(req)
                    if not promoted:
                        self.stats["t2_dropped"] += 1

    def _apply_promotion(self, tokens, j: int, keys: list, staged: dict,
                         event) -> int:
        """Re-insert a staged tier-2 edge into the tree and scatter its KV
        bytes into device blocks; returns the blocks promoted (0: dropped).
        The tree may have moved since the lookup, so re-match and keep only
        the still-missing part; a path that changed is dropped."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in staged.values():
                v.record_stream(stream)
        B = self.prefix_block
        nb = j + len(keys)
        j2, _, _ = self.prefix.match(tokens[: nb * B])
        if j2 != j:
            d = j2 - j
            if d < 0 or d >= len(keys):
                return 0
            keys = keys[d:]
            staged = {c: v[d:] for c, v in staged.items()}
            j = j2
        if self.paged_kv:
            try:
                ids = self._allocator.alloc(len(keys))
            except D.PagedPoolOOM:
                return 0  # the pool is the scarce tier: decode wins
            _, _, new_ids = self.prefix.insert(tokens[: nb * B], n_blocks=nb,
                                               block_ids=[0] * j + ids)
            if new_ids:
                self.pool = D.kv_block_import(
                    self.pool, new_ids, {c: v[:len(new_ids)] for c, v in staged.items()})
            # the tree pinned what it adopted: drop the allocation's own
            # refs, which frees any tail the budget did not take
            self._allocator.release(ids)
        else:
            _, first_new, new_ids = self.prefix.insert(tokens[: nb * B], n_blocks=nb)
            d = first_new - j
            if not new_ids or d < 0 or d >= len(keys):
                return 0
            self.pool = D.kv_block_import(
                self.pool, new_ids, {c: v[d:d + len(new_ids)] for c, v in staged.items()})
        self.stats["t2_promoted_blocks"] += len(new_ids)
        record_prefix("t2_promoted_blocks", len(new_ids))
        return len(new_ids)

    def t2_drain(self, timeout: float = 10.0) -> bool:
        """Wait until every scheduled tier-2 promotion has been staged and
        adopted; True on success, False when ``timeout`` seconds pass."""
        if self._promote_worker is None:
            return True
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self.lock:
                if self._t2_pending <= 0:
                    return True
            self.wake.set()
            time.sleep(0.005)
        return False

    def _dispatch_decode(self, active) -> bool:
        """One decode chunk (or spec dispatch) over the active lanes; False
        if none."""
        if not active.any():
            return False
        with self.lock:
            qlen = len(self.queue)
        steps = self._pick_steps(qlen)
        # tick-to-tick wall per dispatched step: in steady state the loop
        # is paced by the card finishing chunks
        now = time.perf_counter()
        if self._last_dispatch_t is not None and self._last_dispatch_steps:
            per = (now - self._last_dispatch_t) / self._last_dispatch_steps
            self._step_wall_ema = (per if self._step_wall_ema is None
                                   else 0.7 * self._step_wall_ema + 0.3 * per)
        self._last_dispatch_t = now
        lanes = to_device(active.copy(), self.device)
        if self.spec_decode and not self._spec_off:
            # `steps` plain lane-steps become n_cycles cycles; budgets and
            # the autotune count cycles here
            lane_steps = max(1, steps // (self.spec_k + 1))
            self.pool, toks, emit = D.pool_decode_spec(
                self.params, self.pool, lanes, self.cfg, lane_steps,
                draft_layers=self.spec_draft_layers, n_spec=self.spec_k)
            payload = (_HostCopy(toks), _HostCopy(emit))
            self.stats["spec_dispatches"] += 1
            self.stats["spec_cycles"] += lane_steps
        else:
            lane_steps = steps
            self.pool, toks = D.pool_decode_chunk(
                self.params, self.pool, lanes, self._gen, self.cfg, steps,
                temperature=self._temperature, top_k=self._top_k,
                top_p=self._top_p, paged_kernel=self.paged_kernel)
            payload = _HostCopy(toks)
        self._last_dispatch_steps = lane_steps
        self._inflight.append((payload, active.copy(), list(self.slots)))
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += lane_steps
        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            self._sent[slot] += lane_steps
            if self.eager_refill and self._sent[slot] >= req.max_new:
                # no later chunk can add to this answer: free the slot now;
                # its tokens drain from the snapshots, and stream order
                # puts the next occupant's writes after this chunk
                self.slots[slot] = None
                active[slot] = False
                self._release_slot_kv(slot)
                with self.lock:
                    self.free.append(int(slot))
        return True

    def _spec_account(self, emit, lanes) -> None:
        """Count one drained spec dispatch (``emit`` (n_cycles, B), the
        lanes active at its dispatch), feed the acceptance EMA and trip the
        latch."""
        cyc, n_act, k = emit.shape[0], len(lanes), self.spec_k
        drafted = cyc * n_act * k
        emitted = int(emit[:, lanes].sum()) if n_act else 0
        accepted = emitted - cyc * n_act
        acc = self._spec_accum
        for name, v in (("dispatches", 1), ("verify_steps", cyc * n_act),
                        ("draft_steps", drafted), ("drafted", drafted),
                        ("accepted", accepted), ("emitted", emitted)):
            acc[name] = acc.get(name, 0) + v
        self.stats["spec_verify_steps"] += cyc * n_act
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        self.stats["spec_emitted"] += emitted
        if drafted:
            rate = accepted / drafted
            self._accept_ema = (rate if self._accept_ema is None
                                else 0.7 * self._accept_ema + 0.3 * rate)
            self._spec_drains += 1
            # below ~1/(k+1) acceptance the drafts are noise
            if (not self._spec_off and self._spec_drains >= 4
                    and self._accept_ema < 0.25):
                self._spec_off = True
                self.spec_latched_at = self._spec_drains

    def _spec_flush(self) -> None:
        """Flush the accumulated spec counters to the ledger (at request
        completions and when the loop goes idle)."""
        if self._spec_accum:
            acc, self._spec_accum = self._spec_accum, {}
            record_spec_many(**acc)

    def _drain(self, rec, active) -> None:
        """Hand one chunk's tokens to the requests it served: a plain
        chunk's steps, or each spec cycle's first ``n_emit`` tokens."""
        payload, was_active, snap_slots = rec
        lanes = np.nonzero(was_active)[0]
        if isinstance(payload, tuple):
            toks, emit = (h.numpy() for h in payload)
            self._spec_account(emit, lanes)
            first = np.arange(toks.shape[2])[None, :] < emit[:, :, None]

            def stream(slot):
                return toks[:, slot][first[:, slot]].tolist()
        else:
            toks = payload.numpy()

            def stream(slot):
                return toks[:, slot].tolist()
        for slot in lanes:
            req = snap_slots[slot]
            if req is None or req.done.is_set():
                continue
            for t in stream(slot):
                if self.eos_id is not None and t == self.eos_id:
                    req.max_new = 0  # stream closed
                    break
                if not req.tokens:
                    req.first_token_at = time.perf_counter()
                req.tokens.append(int(t))
                if len(req.tokens) >= req.max_new:
                    break
            if req.max_new == 0 or len(req.tokens) >= req.max_new:
                req.text = self.tokenizer.decode(req.tokens)
                req.finished_at = time.perf_counter()
                # eager refill may already have freed (and re-admitted) it
                if self.slots[slot] is req:
                    self.slots[slot] = None
                    active[slot] = False
                    self._release_slot_kv(slot)
                    with self.lock:
                        self.free.append(int(slot))
                self._prefix_release(req)
                # a waiter woken by done finds the ledger flushed
                self._spec_flush()
                req.done.set()

    def _loop(self):
        active = np.zeros(self.n_slots, dtype=bool)
        inflight = self._inflight
        while not self._stop:
            # decode FIRST: newcomer admission overlaps the in-flight chunk
            dispatched = self._dispatch_decode(active)
            # adopt staged tier-2 promotions before admissions
            self._drain_promotions()
            admissions = []
            with self.lock:
                while self.queue and self.free:
                    admissions.append((self.free.pop(), self.queue.popleft()))
            direct: list = []
            for slot, req in admissions:
                # the slot record goes in first, so a failing admission
                # still finds (and fails) this request
                self.slots[slot] = req
                self._sent[slot] = 0
                self._admit_one(slot, req, direct)
            self._admit_direct(direct, active)
            held = False
            for slot in list(self._pending_prefill):
                held |= not self._prefill_piece(slot, active)
            if not dispatched:  # the pool was empty: decode the newcomers
                dispatched = self._dispatch_decode(active)
            if dispatched:
                if len(inflight) <= self.pipeline_depth:
                    continue
            elif not inflight:
                if self._pending_prefill and not held:
                    continue
                # idle, or only pieces waiting for a staging promotion
                # (the stage worker sets wake)
                self._spec_flush()
                self.wake.clear()
                self.wake.wait(timeout=0.002 if held else 0.05)
                continue
            self._drain(inflight.popleft(), active)

    def shutdown(self, timeout: float = 10.0):
        self._stop = True
        self.wake.set()
        t = self.thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        if self._promote_worker is not None:
            self._promote_worker.close()


def _host_blob(t: torch.Tensor) -> np.ndarray:
    """A block payload as a host numpy array; bf16, which numpy lacks,
    travels as its int16 bit pattern."""
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _device_blob(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The inverse of :func:`_host_blob` on ``device``: through pinned
    memory and a non-blocking copy on the card (no KV plane is int16, so
    int16 means bf16 bits)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.view(torch.bfloat16) if a.dtype == np.int16 else t


class _HostCopy:
    """A device tensor's copy to the host, started at once: on the card it
    lands in pinned memory without blocking, and ``numpy()`` waits for it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()
