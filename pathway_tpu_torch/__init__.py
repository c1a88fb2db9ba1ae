"""pathway_tpu_torch — the PyTorch/CUDA port of pathway_tpu for one
NVIDIA H100.

It carries the RAG main path: hashing or WordPiece tokenizer (C++ batch
loops, an encode memo) -> MiniLM-style encoder (attention through a
hand-written CUDA flash-attention kernel) -> sentence embedder (a threaded
ingest pipeline, and a text -> vector dedup in the
``SentenceTransformerEmbedder`` seam) and brute-force KNN index ->
cross-encoder rerank, in ``FusedRAGPipeline``; HF checkpoint loaders for
the encoders and the decoder; and the answer LLM: a GPT-2-family decoder served by
``DecoderChat`` (batch-static, or a continuous-batching server over a dense
or paged KV pool, with a prefix KV cache and its host tier) with CUDA
kernels for chunked prefill, paged decode and int8-weight products;
``QueryServer`` micro-batches concurrent queries into one pipeline call a
tick. Entry points run on CUDA unless given ``device="cpu"``. The package
imports neither JAX nor ``pathway_tpu``.

Telemetry is on by default, as in JAX: ``engine.probes`` holds the
metrics registry and its ledgers (``serving_snapshot()``,
``set_metrics(False)`` turns every write off), ``engine.tracing`` the
per-request spans (``recent_traces``, ``configure(trace_dir=...)`` for a
JSONL flight recorder), and ``internals.http_server`` the registry's
OpenMetrics text.

Supervision follows JAX's defaults: ``engine.slo`` (the SLO watchdog and
the degradation ladder the decode server reads, ``slo.configure``),
``engine.chaos`` (fault injection sites, off until ``chaos.configure``),
and the servers' ``serve_restarts`` / ``serve_retries`` /
``request_deadline_ms`` / ``serve_queue`` / ``degradation`` arguments.
"""

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine import probes, tracing
from pathway_tpu_torch.models import (
    MINILM_L6,
    CrossEncoderModel,
    HashTokenizer,
    SentenceEmbedderModel,
    TransformerConfig,
)
from pathway_tpu_torch.ops.fused_query import FusedRAGPipeline
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
from pathway_tpu_torch.ops.query_server import QueryServer
from pathway_tpu_torch.xpacks.llm import DecoderChat

__all__ = [
    "BruteForceKnnIndex",
    "CrossEncoderModel",
    "DecoderChat",
    "FusedRAGPipeline",
    "HashTokenizer",
    "MINILM_L6",
    "QueryServer",
    "SentenceEmbedderModel",
    "TransformerConfig",
    "probes",
    "resolve_device",
    "tracing",
]
