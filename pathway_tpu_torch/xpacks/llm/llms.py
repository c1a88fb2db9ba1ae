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

Telemetry is on by default, as ``PATHWAY_TPU_METRICS`` is in JAX: each
request carries a span (``engine/tracing.py``: admit, prefix match,
prefill, decode chunks, first token, drain) whose finish feeds the TTFT,
TPOT, queue-wait and e2e histograms of ``engine/probes.py``; the server
records the HBM ledger at pool build, attention bytes per admission and
prefill piece, occupancy and lane gauges every 8th chunk, and the KV
fragmentation gauge at admission and release. ``probes.set_metrics(False)``
turns it all off; the token streams do not change.

Supervision follows the JAX server, with its defaults. The SLO
degradation ladder (``engine/slo.py``, ``degradation=True``) is read every
loop tick: level 1 halves each admission's ``max_new``, level 2 turns
speculative decode off, level 3 sheds priority-0 requests; with no
objective declared (``slo.configure``'s default) it never leaves level 0.
``serve_restarts > 0`` supervises the loop: a request-scoped failure
(admission, a prefill piece) fails or re-queues that request alone
within ``serve_retries``, and a loop-scoped one (a decode dispatch)
rebuilds the pool and re-enters the loop with exponential backoff, up to
``serve_restarts`` times, before the failure latches. A CUDA error that
poisons the context cannot be recovered this way: every restart fails
again until the budget is spent and the last error latches.
``request_deadline_ms`` sheds requests whose deadline passes while
queued or decoding, ``serve_queue`` sheds submits past a queue bound.
A failed or shed request resolves to ``encode_serve_error``'s marker with
its reason (and ``retry_after`` for a shed). The chaos sites
``decode.admit`` and ``decode.dispatch`` (``engine/chaos.py``) inject
faults on those paths when chaos is configured.

The features JAX keeps off by default are here too, off by default.
``disagg=True`` splits pending prompts into a prefill lane: while any
slot decodes, at most ``disagg_prefill_budget`` prompts advance one piece
a tick, round-robin, and a finished prompt's KV hands over to the decode
lane where it lies (one card: no copy; the handoff is counted in
``kv_migrated_blocks``). ``tenant_sched=True`` admits by
``engine.slo.TenantScheduler`` (weighted-fair over ``submit(...,
tenant=)``, ``tenant_weights`` such as ``"a:3,b:1"``) and, with
``tenant_budget > 0``, preempts the newest decode-lane request of an
over-budget tenant when an eligible tenant waits and no slot is free: a
paged request's block row parks with its references kept and its
re-admission is a table edit plus a re-prefill of the final partial
block. Greedy streams do not depend on either schedule.

Behaviour is set by constructor arguments whose defaults are the JAX flag
defaults, for every feature the server carries. ``mesh=`` (a serving mesh
from ``parallel.make_serving_mesh``) shards the params and the pool once at
construction and again at a supervised rebuild: tensor-parallel blocks,
head-sharded KV, each attention kernel once per tp shard
(``models/decoder.py``); a one-position mesh serves the single-device
streams byte for byte. Nothing reads an environment variable.
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
from pathway_tpu_torch.engine import chaos, probes, slo, tracing
from pathway_tpu_torch.engine.async_runtime import StageWorker
from pathway_tpu_torch.engine.prefix_cache import PrefixCache
from pathway_tpu_torch.engine.probes import (
    record_prefix,
    record_spec,
    record_spec_many,
    record_stage,
)
from pathway_tpu_torch.internals.errors import get_global_error_log
from pathway_tpu_torch.internals.retries import ExponentialBackoffRetryStrategy
from pathway_tpu_torch.models import decoder as D
from pathway_tpu_torch.models import flash_attention as FA
from pathway_tpu_torch.ops import next_pow2

# Serving failures travel the string response channel as a reserved-prefix
# marker (the \x00 prefix cannot appear in decoded model output).
SERVE_ERROR_MARKER = "\x00pathway_tpu:serve_error\x00"


def encode_serve_error(reason: str, retry_after: float | None = None) -> str:
    payload: dict = {"reason": reason}
    if retry_after is not None:
        payload["retry_after"] = retry_after
    return SERVE_ERROR_MARKER + json.dumps(payload)


def decode_serve_error(text) -> dict | None:
    """The structured error a serving response string carries, or None
    for ordinary responses."""
    if not isinstance(text, str) or not text.startswith(SERVE_ERROR_MARKER):
        return None
    try:
        return json.loads(text[len(SERVE_ERROR_MARKER):])
    except ValueError:
        return {"reason": "serve_failed"}


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
    runs the plain PyTorch path. ``serve_restarts``, ``serve_retries``,
    ``request_deadline_ms``, ``serve_queue`` and ``degradation`` set the
    continuous server's supervision, ``disagg`` / ``disagg_prefill_budget``
    its prefill lane and ``tenant_sched`` / ``tenant_budget`` /
    ``tenant_weights`` its tenant scheduler (defaults: the JAX flag
    defaults, all off)."""

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
        serve_restarts: int = 0,
        serve_retries: int = 1,
        request_deadline_ms: float = 0.0,
        serve_queue: int = 0,
        degradation: bool = True,
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
        # HBM ledger: the decoder's param footprint at placement (int8
        # payloads and scales when quantized), under this chat's owner tag,
        # which its continuous server records its pool under too
        self.hbm_owner = f"chat:{id(self):x}"
        for dev, nbytes in D.params_device_bytes(self.params).items():
            probes.record_hbm("weights.decoder", nbytes, device=dev, owner=self.hbm_owner)
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
                serve_restarts=serve_restarts,
                serve_retries=serve_retries,
                request_deadline_ms=request_deadline_ms,
                serve_queue=serve_queue,
                degradation=degradation,
                hbm_owner=self.hbm_owner,
            )

    @property
    def server(self) -> "_ContinuousServer | None":
        return self._server

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        probes.drop_hbm_owner(self.hbm_owner)

    def recent_traces(self, n: int | None = None) -> list[dict]:
        """Completed request spans of the continuous server (empty when
        batch-static, and with metrics off)."""
        if self._server is None:
            return []
        return self._server.recent_traces(n=n)

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
        # level 3 of the degradation ladder sheds priority <= 0; the
        # tenant steers the tenant scheduler (one FIFO when it is off)
        priority = int(kwargs.pop("priority", 1))
        tenant = str(kwargs.pop("tenant", "default")) or "default"
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
            self.tokenizer.encode(self._format_prompt(m))[-cap:], max_new,
            priority=priority, tenant=tenant)
            for m in messages]

    def resolve_batch(self, handles) -> list:
        out = []
        for reqs in handles:
            texts = []
            for req in reqs:
                req.done.wait()
                if req.text is None:
                    # failed or shed: the reason travels the string channel
                    texts.append(encode_serve_error(req.error_reason or "serve_failed",
                                                    retry_after=req.retry_after))
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
                 "finished_at", "first_token_at", "error_reason", "span",
                 "retries", "retry_after", "deadline", "priority", "tenant",
                 "seq")

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
        self.span = tracing.NULL_SPAN  # replaced by submit()
        # supervision: isolation and restart attempts, the shed's hint,
        # the time.monotonic() deadline, the admission priority class
        self.retries = 0
        self.retry_after: float | None = None
        self.deadline: float | None = None
        self.priority = 1
        # the tenant scheduler's admission class, and the server's
        # admission order (preemption takes the newest)
        self.tenant = "default"
        self.seq = 0


# (argument, asked-for test, what it is) of every JAX serving feature the
# port does not carry: none since the serving mesh
_UNPORTED: tuple = ()


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
    from the halvings of ``chunk_steps`` down to 4.

    Supervision (``serve_restarts > 0``): an admission or prefill-piece
    failure rewinds that request alone (``_isolate_admission_failure``);
    a failure anywhere else in the loop rebuilds the pool and re-queues
    every interrupted request (``_recover_after_crash``), then re-enters
    the loop after a backoff. Each request has ``serve_retries`` retries
    across both.

    Disaggregated lanes (``disagg``): while any lane decodes and more than
    ``disagg_prefill_budget`` prompts are pending, only that many advance
    a piece per tick (``_prefill_lane``). Tenant scheduling
    (``tenant_sched``): the queue pop asks ``TenantScheduler.select``;
    admission charges a request's ``max_new`` to its tenant and every exit
    from a slot credits the same amount back; ``_maybe_preempt`` parks an
    over-budget tenant's newest decode-lane request and ``_unpark``
    re-admits it onto its own row."""

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
                 chunk_autotune: bool | None = None,
                 serve_restarts: int = 0,
                 serve_retries: int = 1,
                 request_deadline_ms: float = 0.0,
                 serve_queue: int = 0,
                 degradation: bool = True,
                 hbm_owner: str | None = None):
        asked: dict = {}
        for name, on, what in _UNPORTED:
            if on(asked[name]):
                raise NotImplementedError(
                    f"{name}: {what} is not ported to pathway_tpu_torch yet")
        self.cfg = cfg
        # the serving mesh, read once: params shard here, the pool in
        # _build_pool (so a supervised rebuild re-shards it identically)
        self.mesh = mesh
        self.params = D.shard_decoder_params(params, cfg, mesh)
        self.device = self.params["wte"].device
        # tags this server's request spans and gauges
        self._trace_tag = f"decode:{id(self):x}"
        # the HBM ledger's owner of this server's pool and weights (its
        # chat's tag when a DecoderChat built it), dropped at shutdown
        self.hbm_owner = hbm_owner or self._trace_tag
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
        # slot -> KV columns its request can reach: the numerator of the
        # fragmentation gauge, dense and paged
        self._slot_cover: dict[int, int] = {}
        self._kv_frag = 0.0
        self._frag_sum = 0.0
        self._frag_n = 0
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
        # HBM ledger, once at pool build: each pool component and the
        # weights the server decodes with
        for comp, per_dev in D.pool_component_device_bytes(self.pool).items():
            for dev, nbytes in per_dev.items():
                probes.record_hbm(comp, nbytes, device=dev, owner=self.hbm_owner)
        for dev, nbytes in D.params_device_bytes(self.params).items():
            probes.record_hbm("weights.decoder", nbytes, device=dev, owner=self.hbm_owner)
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
        # supervision, all read once here: restarts and per-request
        # isolation only when supervised; deadlines and the queue bound
        # shed instead of blocking; the ladder follows the SLO watchdog
        self._restart_budget = max(0, int(serve_restarts))
        self._supervised = self._restart_budget > 0
        self._retry_budget = max(0, int(serve_retries))
        self._deadline_s = float(request_deadline_ms) / 1e3
        self._queue_bound = max(0, int(serve_queue))
        self._default_max_new = int(default_max_new)
        self._degradation_level = 0
        self._degrade = slo.get_degradation_controller() if degradation else None
        self._chaos_admit = chaos.site("decode.admit")
        self._chaos_dispatch = chaos.site("decode.dispatch")
        # disaggregated lanes: the prefill lane's per-tick budget and its
        # round-robin cursor; lane_stats() reads the counts of the last tick
        self.disagg = bool(disagg)
        self._prefill_budget = max(1, 1 if disagg_prefill_budget is None
                                   else int(disagg_prefill_budget))
        self._prefill_rr = 0
        self._lane_counts = {"prefill": 0, "decode": 0}
        # tenant scheduling: a pop policy over the one queue, and budgets
        # enforced by preemption
        self._tenants = None
        if tenant_sched:
            self._tenants = slo.TenantScheduler(
                weights=slo.TenantScheduler.parse_weights(tenant_weights or ""),
                budget_tokens=int(tenant_budget or 0))
        self._tenants_seen: set = set()  # tenants that queued (under lock)
        # preempted paged requests' rows, refs kept: req -> block row
        self._parked: dict = {}
        self._parked_blocks = 0
        self._admit_seq = 0
        # id(req) -> (tenant, tokens charged): EOS and the level-1 clamp
        # change req.max_new, and the credit must match the charge
        self._charged: dict[int, tuple[str, int]] = {}
        # one paged block's K+V bytes, the kv_parked_bytes multiplier
        it = torch.empty((), dtype=cfg.dtype).element_size()
        per_tok = cfg.head_dim + 4 if self.kv_quant else cfg.head_dim * it
        self._block_kv_bytes = (2 * cfg.layers * cfg.heads * self.paged_block * per_tok
                                if self.paged_kv else 0)
        # steps / slot_steps_total: useful lane-steps over dispatched ones
        # (occupancy())
        self.stats = {"chunks": 0, "admitted": 0, "decode_steps": 0,
                      "steps": 0, "slot_steps_total": 0,
                      "prefill_chunks": 0, "admit_dispatches": 0,
                      "prefix_hit_tokens": 0, "prefix_miss_tokens": 0,
                      "prefix_hit_requests": 0, "prefix_requests": 0,
                      "t2_hit_requests": 0, "t2_promoted_blocks": 0,
                      "t2_dropped": 0, "spec_dispatches": 0, "spec_cycles": 0,
                      "spec_drafted": 0, "spec_accepted": 0, "spec_emitted": 0,
                      "spec_verify_steps": 0, "restarts": 0,
                      "request_failures": 0, "request_retries": 0, "shed": 0,
                      "leaked_thread": 0, "preemptions": 0, "unparked": 0,
                      "kv_migrated_blocks": 0}
        # in-flight chunk records, oldest first
        self._inflight: deque = deque()
        self._occ_published = 0  # the chunk count at the last gauge write
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
            pool = D.paged_pool_init(
                self.params, self.cfg, self.n_slots, self.cache_len,
                n_blocks=self._total_blocks, block=self.paged_block,
                kv_quant=bool(self.kv_quant))
        else:
            pool = D.pool_init(self.params, self.cfg, self.n_slots, self.cache_len,
                               kv_quant=bool(self.kv_quant), arena_blocks=cached,
                               arena_block=self.prefix_block)
        return D.shard_pool(pool, self.cfg, self.mesh)

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
        """Drop a freed slot's fragmentation cover. A freed paged slot's
        table row points at the sentinel BEFORE its blocks return to the
        allocator, so no stale row ever references a block that a new owner
        writes. On shared prefix blocks the release drops only the slot's
        own pin; the tree's pin keeps them."""
        self._slot_cover.pop(slot, None)
        if self._allocator is not None:
            row = self._slot_blocks.pop(slot, None)
            if row:
                M = self.cache_len // self.paged_block
                self.pool = D.paged_table_set(self.pool, slot, np.zeros((M,), np.int32))
                self._allocator.release(row)
        self._update_fragmentation()

    def _update_fragmentation(self) -> None:
        """Refresh the ``kv_fragmentation`` gauge: 1 - reachable / allocated
        KV columns over the admitted slots. A dense slot allocates the whole
        ``cache_len`` row, a paged slot only its table's blocks."""
        covers = self._slot_cover
        if not covers:
            frag = 0.0
        else:
            needed = sum(covers.values())
            if self.paged_kv:
                alloc = sum(len(self._slot_blocks.get(s, ())) * self.paged_block
                            for s in covers)
            else:
                alloc = len(covers) * self.cache_len
            frag = max(0.0, 1.0 - needed / alloc) if alloc else 0.0
            self._frag_sum += frag
            self._frag_n += 1
        self._kv_frag = frag
        probes.record_kv_fragmentation(frag, server=self._trace_tag)

    def kv_fragmentation(self) -> dict:
        """Current and admission-averaged stranded-KV fraction."""
        return {"current": float(self._kv_frag),
                "mean": (self._frag_sum / self._frag_n) if self._frag_n else 0.0}

    def occupancy(self) -> float:
        """Useful lane-steps over dispatched lane-steps (slots x steps) of
        every decode chunk so far: the share of the pool's decode compute
        that served live lanes within their budgets."""
        return self.stats["steps"] / max(self.stats["slot_steps_total"], 1)

    def recent_traces(self, n: int | None = None) -> list[dict]:
        """Completed request spans of THIS server (oldest first) from the
        bounded trace ring; empty with metrics off."""
        return tracing.recent_traces(server=self._trace_tag, n=n)

    def _record_attn(self, path: str, n_q: int, n_k: int, batch: int = 1,
                     cached_kv: bool = False) -> None:
        """Charge the attention-bytes ledger for one prefill dispatch (an
        accounting model, see ``probes.record_attn``). ``cached_kv=True``
        bills KV reads at the pool's storage width (int8 under kv_quant)."""
        cfg = self.cfg
        dense = cfg.layers * FA.attn_bytes_dense(n_q, n_k, cfg.heads, batch=batch)
        if self.flash_prefill:
            item = 1 if (cached_kv and self.kv_quant) else torch.finfo(cfg.dtype).bits // 8
            fl = cfg.layers * FA.attn_bytes_flash(n_q, n_k, cfg.heads, cfg.head_dim,
                                                  batch=batch, itemsize=item)
            probes.record_attn(path, fl, saved=dense - fl)
        else:
            probes.record_attn(path, dense)

    def _fail_request(self, req, reason: str) -> None:
        """Terminal failure of ONE request (the server keeps serving): the
        text=None sentinel and a structured reason."""
        self._discard_parked(req)
        self._tenant_credit(req)
        req.error_reason = reason
        req.text = None
        probes.REGISTRY.counter_add("requests_isolated", outcome="failed")
        with self.lock:
            self.stats["request_failures"] += 1
        req.span.finish(error=True, tokens=len(req.tokens))
        req.done.set()

    def _shed_request(self, req, reason: str) -> None:
        """Admission-control shed (deadline / queue_full / degraded):
        terminal, structured, counted, with a retry hint."""
        self._discard_parked(req)
        self._tenant_credit(req)
        req.error_reason = f"shed:{reason}"
        req.retry_after = 1.0
        req.text = None
        probes.REGISTRY.counter_add("requests_shed", reason=reason)
        with self.lock:
            self.stats["shed"] += 1
        req.span.finish(error=True, tokens=len(req.tokens))
        req.done.set()

    def _retry_or_fail(self, req, exc: BaseException, event: str, **attrs) -> bool:
        """Count one more attempt of ``req``: True when it is still within
        the retry budget (the caller re-queues it), else fail it."""
        req.retries += 1
        if req.retries <= self._retry_budget:
            req.span.event(event, **attrs)
            probes.REGISTRY.counter_add("requests_isolated", outcome="retried")
            with self.lock:
                self.stats["request_retries"] += 1
            return True
        get_global_error_log().log(
            f"request failed after {req.retries - 1} retries: "
            f"{type(exc).__name__}: {exc}")
        self._fail_request(req, "failed")
        return False

    def _isolate_admission_failure(self, slot: int, req, exc: Exception, active) -> None:
        """Rewind ONE request's admission (slot record, pending pieces,
        prefix pins, KV blocks, lane) and re-queue it within its retry
        budget; past the budget it fails alone. The rest keeps serving."""
        self.slots[slot] = None
        self._pending_prefill.pop(slot, None)
        active[slot] = False
        self._prefix_release(req)
        self._release_slot_kv(slot)
        self._tenant_credit(req)  # charged again if the re-queue admits
        with self.lock:
            self.free.append(int(slot))
        if self._retry_or_fail(req, exc, "retry", error=type(exc).__name__):
            with self.lock:
                self.queue.appendleft(req)

    def _recover_after_crash(self, exc: BaseException) -> None:
        """Reset the server to an admittable state after a loop-scoped
        crash: fence the card, rebuild the pool, clear the slot, prefill
        and in-flight bookkeeping, drop the (now unbacked) prefix tree and
        staged promotions, and re-queue every interrupted request within
        its retry budget."""
        get_global_error_log().log(
            f"decoder serving loop crashed ({type(exc).__name__}: {exc}); "
            f"supervised restart")
        probes.REGISTRY.counter_add("serve_restarts", server=self._trace_tag)
        if self.device.type == "cuda":
            # copies still queued against the old pool or the in-flight
            # chunk records must land before the caching allocator hands
            # their memory to the rebuilt pool
            torch.cuda.synchronize(self.device)
        victims: list = []
        with self.lock:
            for rec in self._inflight:
                victims.extend(r for r in rec[2] if r is not None)
            self._inflight.clear()
            victims.extend(r for r in self.slots if r is not None)
            for i in range(self.n_slots):
                self.slots[i] = None
            self.free = list(range(self.n_slots))
            self.stats["restarts"] += 1
            # no request may hold its last piece for a promotion that
            # targets the tree dropped below
            self._t2_waiting.clear()
        self._pending_prefill.clear()
        self._sent = [0] * self.n_slots
        self._slot_cover.clear()
        self._slot_blocks.clear()
        # parked rows live in the allocator replaced below: their queued
        # requests re-admit from the prompt
        self._release_parked()
        self.pool = None  # one pool's worth of memory at a time
        self.pool = self._build_pool()
        # the old tree's pins died with the allocator just replaced: they
        # must not release into the new one
        self.prefix_reset(unpin=False)
        self._update_fragmentation()
        requeue, seen = [], set()
        for req in victims:
            if id(req) in seen or req.done.is_set():
                continue
            seen.add(id(req))
            self._tenant_credit(req)  # charged again at re-admission
            if self._retry_or_fail(req, exc, "restart_requeue", attempt=req.retries + 1):
                # a restart re-decodes from the prompt
                req.tokens = []
                req.first_token_at = None
                requeue.append(req)
        with self.lock:
            self.queue.extendleft(reversed(requeue))

    def _run_safe(self):
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._supervise()
            else:
                self._supervise()
        except BaseException as exc:  # noqa: BLE001 - never hang waiters
            self.failed = exc
            get_global_error_log().log(
                f"decoder serving loop died: {type(exc).__name__}: {exc}")
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
                self._tenant_credit(req)
                if not req.done.is_set():
                    req.text = None
                    req.span.finish(error=True, tokens=len(req.tokens))
                    req.done.set()
            # no parked request will re-admit: their rows go back
            self._release_parked()

    def _supervise(self):
        """The loop, re-entered after a recovered crash with exponential
        backoff (20, 40, 80 ... ms, capped at 2 s) up to the restart
        budget; unsupervised, the first failure propagates."""
        if not self._supervised:
            self._loop()
            return

        def cycle():
            try:
                self._loop()
            except Exception as exc:
                self._recover_after_crash(exc)
                raise

        ExponentialBackoffRetryStrategy(
            max_retries=self._restart_budget, initial_delay=20, backoff_factor=2,
            jitter_ms=10, max_delay_ms=2000).invoke_sync(cycle)

    def submit(self, prompt_ids: list, max_new: int, *, priority: int = 1,
               tenant: str = "default") -> _PendingCompletion:
        req = _PendingCompletion(list(prompt_ids), int(max_new))
        req.priority = int(priority)
        req.tenant = str(tenant) or "default"
        req.span = tracing.start_span(
            "decode", server=self._trace_tag, prompt_tokens=len(req.ids),
            max_new=req.max_new, tenant=req.tenant)
        if self._deadline_s > 0:
            # monotonic, the clock of the loop's deadline sweep
            req.deadline = time.monotonic() + self._deadline_s
        shed_reason = None
        with self.lock:
            if self.failed is not None:
                raise RuntimeError(f"decoder serving loop died: {self.failed!r}")
            if self._stop:
                raise RuntimeError("decoder serving loop is shut down")
            if self._queue_bound > 0 and len(self.queue) >= self._queue_bound:
                # over the bound: shed now instead of queueing what the
                # deadlines could never drain
                shed_reason = "queue_full"
            elif self._degradation_level >= 3 and req.priority <= 0:
                shed_reason = "degraded"
            else:
                self.queue.append(req)
                if self._tenants is not None:
                    self._tenants_seen.add(req.tenant)
                # the observed arrival gap feeds the chunk-steps autotune
                now = req.submitted_at
                if self._last_submit_t is not None:
                    gap = now - self._last_submit_t
                    self._arrival_ema = (gap if self._arrival_ema is None
                                         else 0.8 * self._arrival_ema + 0.2 * gap)
                self._last_submit_t = now
        if shed_reason is not None:
            self._shed_request(req, shed_reason)
            return req
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
        req.span.event("admit", slot=int(slot))
        if self._degradation_level >= 1:
            # ladder level 1+: a shorter answer recycles the slot sooner;
            # before the paged cover below is sized from max_new
            req.max_new = min(req.max_new, max(1, self._default_max_new // 2))
        if self.paged_kv:
            self._admit_one_paged(slot, req, e, n)
            return
        # a dense slot holds the whole cache_len row whatever it reaches
        self._slot_cover[slot] = min(
            self.cache_len, n + req.max_new + (self.pipeline_depth + 1) * self._slack)
        self._update_fragmentation()
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
        req.span.event("prefix_match", hit_blocks=int(m_hit), hit_tokens=int(hit_t),
                       miss_tokens=int(n - hit_t))
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
        parked = self._parked.pop(req, None)
        if parked is not None:
            self._parked_blocks -= len(parked)
            self._record_parked()
            if self._unpark(slot, req, e, n, parked):
                return
            # the row no longer fits the (clamped) budget: a fresh
            # admission re-prefills the whole prompt
            self._allocator.release(parked)
        m_hit, pool_ids, node = self._prefix_match(req, e, n)
        cover, need = self._paged_cover(m_hit * B, n, req.max_new)
        try:
            fresh = self._allocator.alloc(need - m_hit)
        except D.PagedPoolOOM as oom:
            self.slots[slot] = None
            with self.lock:
                self.free.append(int(slot))
            if need - m_hit > self._total_blocks - 1:
                self._fail_request(req, "paged_oom")  # can never fit
                return
            req.span.event("paged_oom", want=int(oom.want), free=int(oom.free))
            self._tenant_credit(req)  # charged again when it admits
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
        self._slot_cover[slot] = cover
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
        self._update_fragmentation()

    def _paged_cover(self, n_cached: int, n: int, max_new: int) -> tuple[int, int]:
        """(KV columns a paged request can reach, blocks its row needs) for a
        prompt of ``n`` tokens prefilled right-padded from column
        ``n_cached`` (a multiple of the piece). Decode writes from the end
        of the last piece, up to P - 1 columns past the prompt: the cover
        counts from that padded width, so no decode column falls past the
        row onto the sentinel block."""
        P, B = self.prefill_chunk, self.paged_block
        width = n_cached + -(-(n - n_cached) // P) * P
        cover = min(self.cache_len,
                    width + max_new + (self.pipeline_depth + 1) * self._slack)
        return cover, min(self.cache_len // B, -(-cover // B))

    def _unpark(self, slot: int, req, e: list, n: int, row: list) -> bool:
        """Re-admit a preempted request onto its own parked row: the blocks
        before the final partial one still hold its prompt's KV (their refs
        never dropped), so admission is one table edit plus a re-prefill of
        the pieces from that block on, which regenerates the first-token
        logits. The pieces start on a block boundary, a multiple of the
        piece, so they line up with the original ones. False when the row
        is not the size the request now needs (a clamped ``max_new``)."""
        B = self.paged_block
        n_cached = ((n - 1) // B) * B
        cover, need = self._paged_cover(n_cached, n, req.max_new)
        if len(row) != need:
            return False
        self._slot_blocks[slot] = row
        self._slot_cover[slot] = cover
        row_arr = np.zeros((self.cache_len // B,), np.int32)
        row_arr[:len(row)] = row
        self.pool = D.paged_admit_cached(self.pool, slot, row_arr, n_cached)
        req.span.event("unpark", blocks=len(row), cached=int(n_cached))
        pieces, meta = self._right_pieces(e, n, n_cached)
        if self.prefix is not None and n >= B:
            meta["insert"] = (req, e, 0)
        self._pending_prefill[slot] = (pieces, n, meta)
        self.stats["admitted"] += 1
        self.stats["unparked"] += 1
        self._update_fragmentation()
        return True

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
            first=first, last=last, last_col=lc, flash=self.flash_prefill,
            mesh=self.mesh)
        self.stats["prefill_chunks"] += 1
        self._record_attn("chunk", int(p_ids.shape[1]), self.cache_len, cached_kv=True)
        req_p = self.slots[slot]
        if req_p is not None:
            req_p.span.event("prefill_chunk", offset=int(off), width=int(p_ids.shape[1]),
                             last=bool(last))
        if last:
            del self._pending_prefill[slot]
            active[slot] = True
            if self.disagg:
                # the lane handoff: the finished prompt's KV joins the
                # decode lane where it lies (one card: the slot's row, no
                # copy); counted only under the flag
                nb = (len(self._slot_blocks.get(slot, ())) if self.paged_kv
                      else -(-int(n_prompt) // self.prefill_chunk))
                self.stats["kv_migrated_blocks"] += nb
                probes.REGISTRY.counter_add("kv_migrated_blocks", nb, server=self._trace_tag)
                if req_p is not None:
                    req_p.span.event("migrate", blocks=int(nb))
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
                                         slots[0], self.cfg, flash=self.flash_prefill,
                                         mesh=self.mesh)
            else:
                self.pool = D.pool_admit_batch(self.params, ids, mask, self.pool,
                                               slots, self.cfg, flash=self.flash_prefill,
                                               mesh=self.mesh)
            s = part[0][3]
            self._record_attn("prefill", s, s, batch=len(part))
            self.stats["admit_dispatches"] += 1
            for slot in slots:
                active[slot] = True
        for slot, _, mask, _, ins in direct:
            req_d = self.slots[slot]
            if req_d is not None:
                req_d.span.event("prefill", tokens=int(mask.sum()))
            if ins is not None:
                self._prefix_insert(slot, *ins)

    # -- lanes, tenants and preemption ---------------------------------

    def _prefill_lane(self, active) -> list:
        """The pending prompts that advance a piece this tick: all of them,
        or under ``disagg`` with a decode lane active, ``_prefill_budget``
        of them taken round-robin, so every pending prompt advances within
        ``ceil(pending / budget)`` ticks."""
        pend = list(self._pending_prefill)
        if self.disagg and active.any() and len(pend) > self._prefill_budget:
            start = self._prefill_rr % len(pend)
            pend = [pend[(start + k) % len(pend)] for k in range(self._prefill_budget)]
            self._prefill_rr += self._prefill_budget
        return pend

    def _count_lanes(self, active) -> dict:
        self._lane_counts = {"prefill": len(self._pending_prefill),
                             "decode": int(active.sum())}
        return self._lane_counts

    def lane_stats(self) -> dict:
        """Slots mid-prompt (prefill lane) and slots decoding (decode lane)
        at the last loop tick; the counts the ``lane_occupancy`` gauges
        carry."""
        return dict(self._lane_counts)

    def tenant_depths(self) -> dict:
        """Queued requests per tenant."""
        depth: dict[str, int] = {}
        with self.lock:
            for r in self.queue:
                depth[r.tenant] = depth.get(r.tenant, 0) + 1
        return depth

    def _tenant_charge(self, req) -> None:
        """Admission charges the request's decode budget to its tenant."""
        if self._tenants is None:
            return
        amt = int(req.max_new)
        self._tenants.charge(req.tenant, amt)
        self._charged[id(req)] = (req.tenant, amt)

    def _tenant_credit(self, req) -> None:
        """Credit back what the request's admission charged (nothing twice)."""
        if self._tenants is None:
            return
        rec = self._charged.pop(id(req), None)
        if rec is not None:
            self._tenants.credit(*rec)

    def _record_parked(self) -> None:
        """The ``kv_parked_bytes`` gauge: parked rows are held on purpose,
        so they count apart from the fragmentation gauge."""
        probes.record_kv_parked(self._parked_blocks * self._block_kv_bytes,
                                server=self._trace_tag)

    def _discard_parked(self, req) -> None:
        """Release a parked request's row (it will never re-admit)."""
        row = self._parked.pop(req, None)
        if row is None:
            return
        self._parked_blocks -= len(row)
        if self._allocator is not None:
            self._allocator.release(row)
        self._record_parked()

    def _release_parked(self) -> None:
        """Release every parked row (a restart, the loop's end)."""
        parked, self._parked = self._parked, {}
        if self._allocator is not None:
            for row in parked.values():
                self._allocator.release(row)
        self._parked_blocks = 0
        if parked:
            self._record_parked()

    def _preempt_request(self, slot: int, req, active) -> None:
        """Take ``slot`` from an over-budget request: park its paged row with
        the allocator refs kept (its table row goes back to the sentinel),
        null it out of every dispatched chunk record so no old token drains
        into the rewound stream, and re-queue it at the head. A scheduling
        decision, not a failure: no retry is spent and nothing is shed."""
        req.span.event("preempt", slot=int(slot), tenant=req.tenant)
        self.slots[slot] = None
        self._pending_prefill.pop(slot, None)
        active[slot] = False
        self._sent[slot] = 0
        self._prefix_release(req)
        self._slot_cover.pop(slot, None)
        if self._allocator is not None:
            row = self._slot_blocks.pop(slot, None)
            if row:
                M = self.cache_len // self.paged_block
                self.pool = D.paged_table_set(self.pool, slot, np.zeros((M,), np.int32))
                self._parked[req] = row
                self._parked_blocks += len(row)
                self._record_parked()
        self._update_fragmentation()
        for rec in self._inflight:
            snap = rec[2]
            for i, r in enumerate(snap):
                if r is req:
                    snap[i] = None
        req.tokens = []
        req.first_token_at = None
        self._tenant_credit(req)
        probes.REGISTRY.counter_add("preemptions", tenant=req.tenant)
        with self.lock:
            self.stats["preemptions"] += 1
            self.free.append(int(slot))
            self.queue.appendleft(req)

    def _maybe_preempt(self, active) -> None:
        """Budget enforcement past skipping: when an eligible tenant waits,
        no slot is free and a tenant is over its budget, preempt that
        tenant's newest-admitted decode-lane request. A slot still
        mid-prefill is never a victim: its row holds uncomputed KV."""
        if self._tenants is None or self._tenants.budget_tokens <= 0:
            return
        with self.lock:
            if not self.queue or self.free:
                return
            entries = [(r.tenant, r.max_new) for r in self.queue]
        if self._tenants.select(entries, charge=False) is None:
            return  # every waiter is over budget itself: hold
        victim = None
        for slot, req in enumerate(self.slots):
            if (req is None or req.done.is_set() or not active[slot]
                    or slot in self._pending_prefill
                    or not self._tenants.over_budget(req.tenant)):
                continue
            if victim is None or req.seq > self.slots[victim].seq:
                victim = slot
        if victim is not None:
            self._preempt_request(victim, self.slots[victim], active)

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
                probes.record_device_dispatch("prefix_extract")
        old = self._prefix_nodes.get(req)
        self.prefix.acquire(node)
        if old is not None:
            self.prefix.release(old)
        self._prefix_nodes[req] = node

    def _prefix_release(self, req) -> None:
        node = self._prefix_nodes.pop(req, None)
        if node is not None:
            self.prefix.release(node)

    def prefix_reset(self, *, unpin: bool = True) -> None:
        """Drop every cached prefix and zero the server's prefix counters.
        Call only while no request is in flight: a paged pool's cached
        blocks unpin back to the allocator, a dense arena starts empty, and
        staged promotions are dropped with the tree they targeted. A
        supervised restart passes ``unpin=False``: its pool rebuild already
        replaced the allocator the old pins lived in."""
        if self.prefix is None:
            return
        self._prefix_nodes.clear()
        if self.paged_kv and unpin:
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
        if self._chaos_dispatch is not None:
            # loop-scoped: every in-flight lane is affected, so recovery is
            # a supervised restart, not a per-request rewind
            self._chaos_dispatch.maybe_fail()
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
        if self.spec_decode and not self._spec_off and self._degradation_level < 2:
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
                top_p=self._top_p, paged_kernel=self.paged_kernel, mesh=self.mesh)
            payload = _HostCopy(toks)
        self._last_dispatch_steps = lane_steps
        self._inflight.append((payload, active.copy(), list(self.slots)))
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += lane_steps
        self.stats["slot_steps_total"] += self.n_slots * lane_steps
        # the occupancy and lane gauges on the 1st and every 8th chunk: a
        # gauge write per chunk is overhead on the dispatch path
        if (self.stats["chunks"] & 7) == 1:
            self._publish_occupancy(active)
        for slot in np.nonzero(active)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            # useful lane-steps only: a lane decoding past its budget while
            # its tokens drain is busy but wasted
            self.stats["steps"] += min(lane_steps, max(0, req.max_new - self._sent[slot]))
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

    def _publish_occupancy(self, active) -> None:
        """Write the occupancy and lane gauges. JAX writes them on the 1st
        and every 8th chunk only; the port also writes them when the loop
        goes idle, so a reader after a burst sees its final occupancy."""
        tag = self._trace_tag
        probes.REGISTRY.gauge_set("serving_occupancy", self.occupancy(), server=tag)
        for lane, count in self._count_lanes(active).items():
            probes.REGISTRY.gauge_set("lane_occupancy", float(count), server=tag, lane=lane)
        if self._tenants is not None:
            # every tenant that ever queued: an empty queue reads 0, not
            # its last depth
            depths = self.tenant_depths()
            with self.lock:
                seen = sorted(self._tenants_seen)
            for t in seen:
                probes.REGISTRY.gauge_set("tenant_queue_depth", float(depths.get(t, 0)),
                                          server=tag, tenant=t)
        self._occ_published = self.stats["chunks"]

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
        spec = isinstance(payload, tuple)
        if spec:
            toks, emit = (h.numpy() for h in payload)
            self._spec_account(emit, lanes)
            first = np.arange(toks.shape[2])[None, :] < emit[:, :, None]
            cyc = emit.shape[0]
        else:
            toks = payload.numpy()
        for slot in lanes:
            req = snap_slots[slot]
            if req is None or req.done.is_set():
                continue
            if (self._deadline_s > 0.0 and req.deadline is not None
                    and req.deadline <= time.monotonic()):
                # an admitted request past its deadline frees its slot now
                # instead of decoding an answer its caller gave up on
                if self.slots[slot] is req:
                    self.slots[slot] = None
                    active[slot] = False
                    self._release_slot_kv(slot)
                    with self.lock:
                        self.free.append(int(slot))
                self._prefix_release(req)
                self._shed_request(req, "deadline_inflight")
                continue
            if spec:
                stream = toks[:, slot][first[:, slot]].tolist()
                req.span.event("spec_cycles", cycles=int(cyc), emitted=len(stream),
                               accepted=len(stream) - int(cyc))
            else:
                stream = toks[:, slot].tolist()
                req.span.event("decode_chunk", steps=len(stream))
            for t in stream:
                if self.eos_id is not None and t == self.eos_id:
                    req.max_new = 0  # stream closed
                    break
                if not req.tokens:
                    req.first_token_at = time.perf_counter()
                    req.span.event("first_token")
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
                self._tenant_credit(req)
                # a waiter woken by done finds the ledger flushed and the
                # span recorded
                self._spec_flush()
                req.span.event("drain")
                req.span.finish(tokens=len(req.tokens))
                req.done.set()

    def _take_admissions(self) -> list:
        """Pop the queue into free slots, shedding what the deadline sweep
        and the ladder refuse; returns ``(slot, request)`` pairs."""
        admissions, shed = [], []
        with self.lock:
            if self._deadline_s > 0.0 and self.queue:
                # requests whose deadline lapsed while queued: running them
                # spends the card on answers their callers gave up on
                now = time.monotonic()
                kept = []
                for r in self.queue:
                    if r.deadline is not None and r.deadline <= now:
                        shed.append((r, "deadline"))
                    else:
                        kept.append(r)
                if shed:
                    self.queue.clear()
                    self.queue.extend(kept)
            now = time.monotonic()
            while self.queue and self.free:
                if self._tenants is not None:
                    # the weighted-fair pop: the oldest entry of the tenant
                    # the scheduler picks; None while every waiter is over
                    # its budget
                    i = self._tenants.select([(r.tenant, r.max_new) for r in self.queue])
                    if i is None:
                        break
                    req = self.queue[i]
                    del self.queue[i]
                else:
                    req = self.queue.popleft()
                if self._degradation_level >= 3 and req.priority <= 0:
                    shed.append((req, "degraded"))
                elif req.deadline is not None and req.deadline <= now:
                    # a deadline can lapse between the sweep and the pop
                    shed.append((req, "deadline"))
                else:
                    self._admit_seq += 1
                    req.seq = self._admit_seq
                    self._tenant_charge(req)
                    admissions.append((self.free.pop(), req))
        for req, reason in shed:
            self._shed_request(req, reason)
        return admissions

    def _loop(self):
        active = np.zeros(self.n_slots, dtype=bool)
        inflight = self._inflight
        while not self._stop:
            # decode FIRST: newcomer admission overlaps the in-flight chunk
            dispatched = self._dispatch_decode(active)
            if self._degrade is not None:
                # one rate-limited watchdog read per tick
                self._degradation_level = self._degrade.maybe_evaluate()
            # adopt staged tier-2 promotions before admissions
            self._drain_promotions()
            direct: list = []
            for slot, req in self._take_admissions():
                # the slot record goes in first, so a failing admission
                # still finds (and fails) this request
                self.slots[slot] = req
                self._sent[slot] = 0
                try:
                    if self._chaos_admit is not None:
                        # request-scoped: only this request's host state
                        self._chaos_admit.maybe_fail()
                    self._admit_one(slot, req, direct)
                except Exception as exc:
                    if not self._supervised:
                        raise
                    self._isolate_admission_failure(slot, req, exc, active)
            self._admit_direct(direct, active)
            held = False
            for slot in self._prefill_lane(active):
                try:
                    held |= not self._prefill_piece(slot, active)
                except Exception as exc:
                    req_p = self.slots[slot]
                    if not self._supervised or req_p is None:
                        raise
                    self._isolate_admission_failure(slot, req_p, exc, active)
            self._maybe_preempt(active)
            self._count_lanes(active)
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
                if self._occ_published != self.stats["chunks"]:
                    self._publish_occupancy(active)
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
            if t.is_alive():
                # a wedged device call or a stuck lock: record it instead
                # of returning as if the shutdown were clean
                with self.lock:
                    self.stats["leaked_thread"] += 1
                get_global_error_log().log(
                    f"serving loop thread {t.name!r} still alive {timeout}s "
                    f"after shutdown join")
        # getattr: shutdown also runs on a partly constructed server
        promote = getattr(self, "_promote_worker", None)
        if promote is not None:
            promote.close()
        # the loop thread is down: every span it will write is written
        tracing.flush_traces()
        # its pool and weights leave the HBM ledger
        owner = getattr(self, "hbm_owner", None)
        if owner is not None:
            probes.drop_hbm_owner(owner)


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
