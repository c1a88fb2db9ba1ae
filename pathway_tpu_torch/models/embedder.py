"""Sentence embedder: encoder + masked mean pooling + L2 normalise
(counterpart of ``pathway_tpu/models/embedder.py``).

Batches are padded to pow2 (rows, seq) buckets as in the JAX package, and
every embed runs the encoder whose attention is the flash kernel on the
card. The vectors are cast to float16 on the card for the device-to-host
copy and renormalised on the host.

``embed_submit`` is pipelined by default (``pipeline=True``, the JAX
default): a tokenize worker feeds a bounded queue (``pipeline_queue``) of
bucket-padded batches to a dispatch worker, which stages each batch on the
card and enqueues its encode, at most ``pipeline_depth`` batches ahead.
On the card the dispatch worker runs on a CUDA stream of its own and
stages through a ring of ``pipeline_depth`` pinned host buffers: under
``fused_h2d`` one ``(2, B, S)`` int32 buffer of ids and mask, one copy;
otherwise two buffers and two copies. Each batch's device-to-host copy
lands in pinned memory and is marked by a CUDA event, which
``embed_resolve`` waits on for that batch alone. ``pipeline=False`` runs
the same stages inline in the caller's thread. Stage seconds go to
``engine/probes.record_stage``: tokenize, h2d, dispatch, drain.

The staging step is the ``embed.h2d`` chaos site (``engine/chaos.py``).
With ``serve_restarts > 0`` a failed stage-and-dispatch is retried up to
``serve_retries`` times with backoff before its error surfaces at
resolve; with the defaults (``serve_restarts=0``) it surfaces at once, as
in JAX.

``weight_quant="int8"`` (JAX's ``PATHWAY_TPU_WEIGHT_QUANT``, off by
default) stores the word table and the layer weights int8 with f32
scales, quantized from the full-precision params (``transformer.py``).

The token-level path (``token_bank_submit`` / ``token_bank_resolve``)
feeds the late-interaction doc bank (``ops/late_bank.py``): the same
stages, but the dispatch keeps per-token states, projected to ``dc``
dims, normalised and int8-quantized, instead of pooling.

Telemetry, on by default as in JAX (``probes.set_metrics``): each
pipelined batch carries a span (``engine/tracing.py``: admit, tokenize,
h2d, dispatch, drain; ``recent_traces``), every encode counts an
``embed_dispatch`` and every resolve an ``embed_drain`` device dispatch,
each encode charges the attention-bytes ledger, and construction records
the weights in the HBM ledger.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine import chaos, tracing
from pathway_tpu_torch.engine.async_runtime import StageWorker
from pathway_tpu_torch.engine.probes import (
    drop_hbm_owner,
    drop_hbm_owner_at_collect,
    record_attn,
    record_device_dispatch,
    record_hbm,
    record_stage,
)
from pathway_tpu_torch.internals.retries import ExponentialBackoffRetryStrategy
from pathway_tpu_torch.models import flash_attention as FA
from pathway_tpu_torch.models.decoder import params_device_bytes
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
    parse_weight_quant,
    quantize_encoder_params,
    shard_encoder_params,
)
from pathway_tpu_torch.ops.late_bank import LATE_DIM, doc_token_states, late_projection


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis; hidden (B,S,H), mask (B,S)."""
    m = mask.float()[:, :, None]
    summed = (hidden * m).sum(dim=1)
    counts = m.sum(dim=1).clamp(min=1.0)
    return summed / counts


def cast_params_for_inference(params: dict, cfg: TransformerConfig) -> dict:
    """Store every float32 weight in the compute dtype (bf16) for
    inference — the layernorm and position tables included, as in the JAX
    embedder."""
    return map_params(
        lambda p: p.to(cfg.dtype) if p.dtype == torch.float32 else p, params
    )


def embed_fn(params, input_ids, attention_mask, cfg: TransformerConfig):
    """Encode, mean-pool, unit-normalise: (B, H) float32."""
    hidden = encode(params, input_ids, attention_mask, cfg)
    pooled = mean_pool(hidden, attention_mask)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)


def _record_encoder_attn(cfg: TransformerConfig, batch: int, seq: int,
                         flash: bool = True) -> None:
    """Charge one encoder dispatch to the attention-bytes ledger (an
    accounting model per layer x batch, see ``probes.record_attn``). The
    port's encoder attention is always the ``flash_attn`` seam."""
    dense = cfg.layers * FA.attn_bytes_dense(seq, seq, cfg.heads, batch=batch)
    if flash:
        paid = cfg.layers * FA.attn_bytes_flash(seq, seq, cfg.heads, cfg.head_dim,
                                                batch=batch)
        record_attn("encoder", paid, saved=max(0, dense - paid))
    else:
        record_attn("encoder", dense)


def _renorm(v: np.ndarray) -> np.ndarray:
    """Restore exact unit norm after the float16 transport quantization."""
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    np.clip(norms, 1e-9, None, out=norms)
    return v / norms


class _PendingEmbed:
    """Handle of the pipelined ``embed_submit`` / ``token_bank_submit``:
    tokenize and dispatch run on the stage workers; :meth:`wait` blocks
    until the batch is dispatched and returns ``(output, rows, CUDA event
    or None)``, the output an f16 tensor or, for token states, an (int8,
    f32) pair. A stage's failure is raised here, at resolve time."""

    __slots__ = ("_event", "_value", "_error", "span")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self.span = tracing.NULL_SPAN  # replaced by _IngestPipeline.submit

    def wait(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"embed batch not dispatched within {timeout} s")
        if self._error is not None:
            raise self._error
        return self._value


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of device tensor ``t`` into pinned host memory,
    on the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class _PinnedRing:
    """``depth`` pinned host staging slots, used in turn. Each slot keeps
    the CUDA event of the last copy that read it; a slot is refilled only
    after that copy has landed, so a later batch never overwrites bytes a
    non-blocking copy has yet to read."""

    def __init__(self, depth: int, n_buffers: int):
        self._slots = [[torch.empty(0, dtype=torch.int32) for _ in range(n_buffers)]
                       for _ in range(max(1, depth))]
        self._events: list = [None] * len(self._slots)
        self._next = 0

    def take(self, numel: int) -> tuple[int, list]:
        """The next slot's buffers, each at least ``numel`` int32 long,
        once that slot's last copy has finished."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()
        bufs = self._slots[i]
        for j, b in enumerate(bufs):
            if b.numel() < numel:
                bufs[j] = torch.empty(numel, dtype=torch.int32, pin_memory=True)
        return i, bufs

    def release(self, i: int, event) -> None:
        self._events[i] = event


class _IngestPipeline:
    """tokenize -> h2d -> dispatch behind ``embed_submit``.

    Two chained :class:`StageWorker` threads: the tokenize worker turns
    text batches (queue bound ``queue_bound``) into bucket-padded id and
    mask arrays; the dispatch worker stages them on the device and
    enqueues the encode (queue bound ``depth``). Dispatch only enqueues
    device work, so batch b+1's tokenization and copy overlap batch b's
    compute. Single-threaded stages keep dispatch in submit order."""

    def __init__(self, model: "SentenceEmbedderModel", depth: int,
                 queue_bound: int, fused_h2d: bool, retries: int = 0):
        self._model = model
        self._fused = bool(fused_h2d)
        # a failed stage-and-dispatch is retried (bounded, backoff) before
        # it surfaces at resolve
        self._chaos_h2d = chaos.site("embed.h2d")
        self._retries = max(0, int(retries))
        # tags this pipeline's batch spans in the trace ring
        self._trace_tag = f"embed:{id(model):x}"
        dev = model.device
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
            # the weights were written on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            self._ring = _PinnedRing(depth, 1 if self._fused else 2)
        self._dispatch = StageWorker(self._dispatch_one, maxsize=depth,
                                     name="pathway-torch:embed-dispatch")
        self._tokenize = StageWorker(self._tokenize_one, maxsize=queue_bound,
                                     name="pathway-torch:embed-tokenize")

    def submit(self, texts: list[str], kind: str = "embed",
               proj=None) -> _PendingEmbed:
        """Queue a batch. ``kind="embed"`` is the pooled-vector path;
        ``kind="tokens"`` keeps per-token states for the late-interaction
        bank, projected by ``proj`` (hidden, dc): the same workers, another
        computation at the dispatch stage."""
        handle = _PendingEmbed()
        handle.span = tracing.start_span("embed", server=self._trace_tag,
                                         texts=len(texts))
        self._tokenize.submit((texts, handle, kind, proj))
        return handle

    def _tokenize_one(self, item) -> None:
        texts, handle, kind, proj = item
        try:
            model = self._model
            t0 = time.perf_counter()
            handle.span.event("admit")
            ids, mask = model.tokenizer(texts, max_length=model.max_length)
            ids, mask = pad_to_buckets(ids, mask)
            record_stage("tokenize", time.perf_counter() - t0)
            handle.span.event("tokenize", texts=len(texts))
        except BaseException as exc:  # noqa: BLE001 - raised at resolve
            handle._error = exc
            handle.span.finish(error=True)
            handle._event.set()
            return
        # blocks while `depth` batches wait for dispatch: the backpressure
        self._dispatch.submit((ids, mask, len(texts), handle, kind, proj))

    def _dispatch_one(self, item) -> None:
        # (ids, mask, rows, handle[, kind, proj]): an embed batch may omit the last two
        ids, mask, n, handle = item[:4]
        kind, proj = item[4:] or ("embed", None)
        try:
            if self._retries > 0:
                ExponentialBackoffRetryStrategy(
                    max_retries=self._retries, initial_delay=20, backoff_factor=2,
                    jitter_ms=10, max_delay_ms=1000,
                ).invoke_sync(lambda: self._stage_and_dispatch(ids, mask, n, handle,
                                                               kind, proj))
            else:
                self._stage_and_dispatch(ids, mask, n, handle, kind, proj)
        except BaseException as exc:  # noqa: BLE001 - raised at resolve
            handle._error = exc
            handle.span.finish(error=True)
        handle._event.set()

    def _stage_and_dispatch(self, ids, mask, n, handle, kind, proj) -> None:
        if self._chaos_h2d is not None:
            self._chaos_h2d.maybe_fail()
        if self._stream is None:
            handle._value = self._dispatch_cpu(ids, mask, n, handle.span, kind, proj)
        else:
            with torch.cuda.device(self._stream.device), torch.cuda.stream(self._stream):
                handle._value = self._dispatch_cuda(ids, mask, n, handle.span, kind, proj)

    def _compute(self, dev_ids, dev_mask, kind, proj):
        """The dispatch stage's device work: the f16 pooled vectors, or the
        (int8, f32) token states of the late-interaction bank (already
        compact, so no transport cast)."""
        model = self._model
        if kind == "tokens":
            out = doc_token_states(model.params, dev_ids, dev_mask, proj, model.cfg)
            record_device_dispatch("token_bank_dispatch")
        else:
            out = embed_fn(model.params, dev_ids, dev_mask, model.cfg).half()
            record_device_dispatch("embed_dispatch")
        _record_encoder_attn(model.cfg, int(dev_ids.shape[0]), int(dev_ids.shape[1]))
        return out

    def _dispatch_cpu(self, ids, mask, n, span, kind, proj):
        model = self._model
        t0 = time.perf_counter()
        if self._fused:
            packed = torch.from_numpy(np.stack((ids, mask)))
            dev_ids, dev_mask = packed[0], packed[1]
        else:
            dev_ids, dev_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        t1 = time.perf_counter()
        record_stage("h2d", t1 - t0)
        span.event("h2d")
        out = self._compute(dev_ids, dev_mask, kind, proj)
        record_stage("dispatch", time.perf_counter() - t1)
        span.event("dispatch", rows=n)
        return out, n, None

    def _dispatch_cuda(self, ids, mask, n, span, kind, proj):
        model, stream = self._model, self._stream
        t0 = time.perf_counter()
        B, S = ids.shape
        slot, bufs = self._ring.take(2 * B * S if self._fused else B * S)
        if self._fused:
            host = bufs[0][: 2 * B * S].view(2, B, S)
            host.numpy()[0], host.numpy()[1] = ids, mask
            packed = host.to(model.device, non_blocking=True)
            dev_ids, dev_mask = packed[0], packed[1]
        else:
            h_ids, h_mask = (b[: B * S].view(B, S) for b in bufs)
            h_ids.numpy()[...], h_mask.numpy()[...] = ids, mask
            dev_ids = h_ids.to(model.device, non_blocking=True)
            dev_mask = h_mask.to(model.device, non_blocking=True)
        staged = torch.cuda.Event()
        staged.record(stream)
        self._ring.release(slot, staged)
        t1 = time.perf_counter()
        record_stage("h2d", t1 - t0)
        span.event("h2d")
        out = self._compute(dev_ids, dev_mask, kind, proj)
        host_out = tuple(_pinned_copy(t) for t in out) if kind == "tokens" \
            else _pinned_copy(out)
        done = torch.cuda.Event()
        done.record(stream)
        record_stage("dispatch", time.perf_counter() - t1)
        span.event("dispatch", rows=n)
        return host_out, n, done

    def close(self) -> None:
        self._tokenize.close()
        self._dispatch.close()


class SentenceEmbedderModel:
    """Host-facing embedder: str batch -> np.ndarray (B, H) unit vectors.

    ``device=None`` runs on the current CUDA device and raises without
    one; ``device="cpu"`` runs the plain PyTorch path. ``params`` is a
    param dict as ``init_params`` makes (e.g. from
    ``params.from_jax_params``); without it the weights are random from
    ``seed``; without a ``tokenizer``, a default ``HashTokenizer`` (C++
    batches, encode memo). ``pipeline``, ``pipeline_depth``,
    ``pipeline_queue`` and ``fused_h2d`` set the ingest pipeline, and
    ``serve_restarts`` / ``serve_retries`` its retry budget (``serve_retries``
    retries when ``serve_restarts > 0``, else none); their defaults are the
    JAX flag defaults. ``weight_quant="int8"`` stores int8 weights (None,
    the default, full precision); ``late_proj`` fixes the ``(hidden, dc)``
    projection of the token path and of its pipelines' late-interaction
    bank (by default the port's seeded ``late_projection``). ``mesh`` (a
    serving mesh) stores the params sharded (``shard_encoder_params``)."""

    def __init__(
        self,
        cfg: TransformerConfig = MINILM_L6,
        params=None,
        tokenizer=None,
        max_length: int = 128,
        seed: int = 0,
        device=None,
        *,
        pipeline: bool = True,
        pipeline_depth: int = 2,
        pipeline_queue: int = 8,
        fused_h2d: bool = True,
        serve_restarts: int = 0,
        serve_retries: int = 1,
        weight_quant: str | None = None,
        late_proj: torch.Tensor | None = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer or HashTokenizer(max_length=max_length)
        self.max_length = max_length
        if params is None:
            params = init_params(seed, cfg)
        params = map_params(lambda p: p.to(self.device), params)
        self.weight_quant = parse_weight_quant(weight_quant)
        if self.weight_quant:
            # scales from the full-precision params; the compute-dtype cast
            # supplies every other leaf
            self.params = quantize_encoder_params(
                params, out=cast_params_for_inference(params, cfg))
        else:
            self.params = cast_params_for_inference(params, cfg)
        # the serving mesh: params placed with the Megatron layout (lenient),
        # gathered on use by each encode
        self.mesh = mesh
        self.params = shard_encoder_params(self.params, cfg, mesh)
        # HBM ledger: the embedder's param footprint at placement (int8
        # payloads and their scales when quantized), under this model's
        # owner so that two live embedders each keep their entry; close(), or
        # the model's collection, drops it
        self.hbm_owner = f"embed:{id(self):x}"
        drop_hbm_owner_at_collect(self, self.hbm_owner)
        for dev, nbytes in params_device_bytes(self.params).items():
            record_hbm("weights.embedder", nbytes, device=dev, owner=self.hbm_owner)
        self.pipeline = bool(pipeline)
        self.pipeline_depth = int(pipeline_depth)
        self.pipeline_queue = int(pipeline_queue)
        self.fused_h2d = bool(fused_h2d)
        self.h2d_retries = int(serve_retries) if int(serve_restarts) > 0 else 0
        self._pipeline: _IngestPipeline | None = None
        self._pipeline_lock = threading.Lock()
        # (hidden, dc) f32 on the device: the constructor's, else built at
        # the first token submit (and cached per width)
        self._late_proj_arg = None if late_proj is None else late_proj.float().to(self.device)
        self._late_proj = self._late_proj_arg

    @classmethod
    def from_local(cls, path: str, cfg: TransformerConfig = MINILM_L6, **kw):
        """Random weights with the local HF tokenizer of ``path``."""
        return cls(cfg=cfg, tokenizer=load_tokenizer(path), **kw)

    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 128, **kw):
        """A local HF checkpoint directory: config, weights and tokenizer
        files (the tokenizer through ``transformers``)."""
        from pathway_tpu_torch.models.checkpoint import load_encoder_checkpoint
        from pathway_tpu_torch.models.params import from_jax_params

        params, cfg, _ = load_encoder_checkpoint(path)
        init = dict(cfg=cfg, params=from_jax_params(params),
                    tokenizer=load_tokenizer(path, max_length=max_length),
                    max_length=max_length)
        init.update(kw)  # explicit caller overrides win
        return cls(**init)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def _maybe_pipeline(self) -> _IngestPipeline | None:
        """The ingest pipeline, built at first use; None when
        ``pipeline=False``."""
        if not self.pipeline:
            return None
        with self._pipeline_lock:
            if self._pipeline is None:
                self._pipeline = _IngestPipeline(
                    self, self.pipeline_depth, self.pipeline_queue, self.fused_h2d,
                    self.h2d_retries)
            return self._pipeline

    def close(self) -> None:
        """Stop the pipeline workers (queued batches are dispatched first)
        and drop this model's weights from the HBM ledger."""
        with self._pipeline_lock:
            pipe, self._pipeline = self._pipeline, None
        if pipe is not None:
            pipe.close()
        drop_hbm_owner(self.hbm_owner)

    def recent_traces(self, n: int | None = None) -> list[dict]:
        """Completed per-batch spans of this model's ingest pipeline (oldest
        first); empty on the serial path and with metrics off."""
        return tracing.recent_traces(server=f"embed:{id(self):x}", n=n)

    def tokenize(self, texts: list[str]):
        """Bucket-padded (ids, mask) as int32 tensors on the device."""
        ids, mask = self.tokenizer(texts, max_length=self.max_length)
        ids, mask = pad_to_buckets(ids, mask)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.cfg.hidden), dtype=np.float32)
        return self.embed_resolve([self.embed_submit(texts)])[0]

    def embed_device(self, texts: list[str]):
        """Embed without leaving the device: (f32 (B', H) tensor, real row
        count), B' being the row bucket."""
        ids, mask = self.tokenize(texts)
        out = embed_fn(self.params, ids, mask, self.cfg)
        record_device_dispatch("embed_dispatch")
        _record_encoder_attn(self.cfg, int(ids.shape[0]), int(ids.shape[1]))
        return out, len(texts)

    def embed_submit(self, texts: list[str]):
        """Enqueue one batch; returns a handle for :meth:`embed_resolve`.
        Pipelined, this returns once the batch is queued (blocking while
        ``pipeline_queue`` batches wait); serial, it tokenizes and
        enqueues the device work here. The vectors are cast to float16 on
        the device (unit vectors: the ~5e-4 relative error is undone by the
        host renormalisation)."""
        pipe = self._maybe_pipeline()
        if pipe is not None:
            return pipe.submit(texts)
        t0 = time.perf_counter()
        ids, mask = pad_to_buckets(*self.tokenizer(texts, max_length=self.max_length))
        t1 = time.perf_counter()
        record_stage("tokenize", t1 - t0)
        ids, mask = (torch.from_numpy(a).to(self.device) for a in (ids, mask))
        t2 = time.perf_counter()
        record_stage("h2d", t2 - t1)
        out = embed_fn(self.params, ids, mask, self.cfg).half()
        record_device_dispatch("embed_dispatch")
        _record_encoder_attn(self.cfg, int(ids.shape[0]), int(ids.shape[1]))
        record_stage("dispatch", time.perf_counter() - t2)
        return out, len(texts)

    def embed_resolve(self, handles, timeout: float | None = None) -> list[np.ndarray]:
        """Fetch every submitted handle -> [(n_i, dim) float32 array].
        Takes pipelined and serial handles mixed, in any order. A pipelined
        handle waits at most ``timeout`` seconds for its dispatch, then on
        its own batch's copy event only."""
        resolved = [h.wait(timeout) if isinstance(h, _PendingEmbed) else (*h, None)
                    for h in handles]
        t0 = time.perf_counter()
        out = []
        for vec, n, done in resolved:
            if done is not None:
                done.synchronize()
            out.append(_renorm(vec[:n].float().cpu().numpy()))
        record_device_dispatch("embed_drain")
        record_stage("drain", time.perf_counter() - t0)
        for h in handles:
            if isinstance(h, _PendingEmbed):
                h.span.event("drain")
                h.span.finish()
        return out

    # -- token-level path: per-token states for the late-interaction bank --
    def late_projection_matrix(self, dc: int | None = None) -> torch.Tensor:
        """The ``(hidden, dc)`` down-projection shared by ingest-time bank
        rows and query-time token states, cached per width. ``dc`` defaults
        to the constructor's ``late_proj`` width, else to ``LATE_DIM``
        (JAX's ``PATHWAY_TPU_LATE_DIM`` default)."""
        arg = self._late_proj_arg
        dc = int(dc) if dc else (arg.shape[1] if arg is not None else LATE_DIM)
        if self._late_proj is None or self._late_proj.shape[1] != dc:
            self._late_proj = (arg if arg is not None and arg.shape[1] == dc
                               else late_projection(self.cfg.hidden, dc).to(self.device))
        return self._late_proj

    def token_bank_submit(self, texts: list[str], dc: int | None = None):
        """Enqueue a token-state encode for the late-interaction bank:
        full-depth encode -> project to ``dc`` -> normalise -> int8 a
        token. Pipelined like :meth:`embed_submit` (the same stage workers);
        resolve with :meth:`token_bank_resolve`."""
        proj = self.late_projection_matrix(dc)
        pipe = self._maybe_pipeline()
        if pipe is not None:
            return pipe.submit(texts, kind="tokens", proj=proj)
        ids, mask = self.tokenize(texts)
        out = doc_token_states(self.params, ids, mask, proj, self.cfg)
        record_device_dispatch("token_bank_dispatch")
        _record_encoder_attn(self.cfg, int(ids.shape[0]), int(ids.shape[1]))
        return out, len(texts)

    def token_bank_resolve(self, handles, timeout: float | None = None
                           ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch submitted token-bank handles -> ``[(payload int8 (n, S,
        dc), scale f32 (n, S, 1))]``, cut to the real row counts. Takes
        pipelined and serial handles mixed, like :meth:`embed_resolve`."""
        resolved = [h.wait(timeout) if isinstance(h, _PendingEmbed) else (*h, None)
                    for h in handles]
        t0 = time.perf_counter()
        out = []
        for (q, sc), n, done in resolved:
            if done is not None:
                done.synchronize()
            out.append((q[:n].cpu().numpy(), sc[:n].cpu().numpy()))
        record_device_dispatch("token_bank_drain")
        record_stage("drain", time.perf_counter() - t0)
        for h in handles:
            if isinstance(h, _PendingEmbed):
                h.span.event("drain")
                h.span.finish()
        return out

    def __call__(self, texts: list[str]) -> np.ndarray:
        return self.embed_batch(texts)
