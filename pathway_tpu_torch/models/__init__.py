"""Models of the port: tokenizers, encoder, flash attention, embedder,
cross-encoder and the HF checkpoint loaders (``models.checkpoint``)."""

from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel
from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
from pathway_tpu_torch.models.flash_attention import (
    flash_attn,
    flash_attn_reference,
)
from pathway_tpu_torch.models.params import from_jax_params, to_numpy
from pathway_tpu_torch.models.tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    load_tokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.models.transformer import (
    MINILM_L6,
    TransformerConfig,
    encode,
    init_params,
)

__all__ = [
    "CrossEncoderModel",
    "HashTokenizer",
    "MINILM_L6",
    "SentenceEmbedderModel",
    "TransformerConfig",
    "WordPieceTokenizer",
    "encode",
    "flash_attn",
    "flash_attn_reference",
    "from_jax_params",
    "init_params",
    "load_tokenizer",
    "pad_to_buckets",
    "to_numpy",
]
