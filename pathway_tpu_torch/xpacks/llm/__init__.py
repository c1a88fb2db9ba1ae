"""LLM pack of the port: the answer LLM (``DecoderChat``), the embedder
seam (``SentenceTransformerEmbedder``) and the reranker seam
(``CrossEncoderReranker``)."""

from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.llms import (
    DecoderChat,
    decode_serve_error,
    encode_serve_error,
)
from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

__all__ = ["CrossEncoderReranker", "DecoderChat", "SentenceTransformerEmbedder",
           "decode_serve_error", "encode_serve_error"]
