"""LLM pack of the port: the answer LLM (``DecoderChat``)."""

from pathway_tpu_torch.xpacks.llm.llms import DecoderChat, encode_serve_error

__all__ = ["DecoderChat", "encode_serve_error"]
