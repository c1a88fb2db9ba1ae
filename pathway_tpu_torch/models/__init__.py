"""Models of the port: tokenizers, encoder, flash attention, embedder,
cross-encoder, the HF checkpoint loaders (``models.checkpoint``) and the
training steps (``models.train``)."""

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
from pathway_tpu_torch.models.train import (
    TrainState,
    contrastive_loss,
    init_decoder_train_state,
    init_train_state,
    lm_loss,
    make_decoder_train_step,
    make_train_step,
)
from pathway_tpu_torch.models.transformer import (
    MINILM_L6,
    TransformerConfig,
    count_params,
    encode,
    init_params,
)

__all__ = [
    "CrossEncoderModel",
    "HashTokenizer",
    "MINILM_L6",
    "SentenceEmbedderModel",
    "TrainState",
    "TransformerConfig",
    "WordPieceTokenizer",
    "contrastive_loss",
    "count_params",
    "encode",
    "flash_attn",
    "flash_attn_reference",
    "from_jax_params",
    "init_decoder_train_state",
    "init_params",
    "init_train_state",
    "lm_loss",
    "load_tokenizer",
    "make_decoder_train_step",
    "make_train_step",
    "pad_to_buckets",
    "to_numpy",
]
