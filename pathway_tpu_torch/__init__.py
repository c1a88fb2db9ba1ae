"""pathway_tpu_torch — the PyTorch/CUDA port of pathway_tpu for one
NVIDIA H100.

It carries the RAG main path: hashing tokenizer -> MiniLM-style encoder
(attention through a hand-written CUDA flash-attention kernel) -> sentence
embedder and brute-force KNN index -> cross-encoder rerank, in
``FusedRAGPipeline``; and the answer LLM: a GPT-2-family decoder served by
``DecoderChat`` (batch-static, or a continuous-batching server over a dense
or paged KV pool) with CUDA kernels for chunked prefill, paged decode and
int8-weight products. Entry points run on CUDA unless given
``device="cpu"``. The package imports neither JAX nor ``pathway_tpu``.
"""

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models import (
    MINILM_L6,
    CrossEncoderModel,
    HashTokenizer,
    SentenceEmbedderModel,
    TransformerConfig,
)
from pathway_tpu_torch.ops.fused_query import FusedRAGPipeline
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
from pathway_tpu_torch.xpacks.llm import DecoderChat

__all__ = [
    "BruteForceKnnIndex",
    "CrossEncoderModel",
    "DecoderChat",
    "FusedRAGPipeline",
    "HashTokenizer",
    "MINILM_L6",
    "SentenceEmbedderModel",
    "TransformerConfig",
    "resolve_device",
]
