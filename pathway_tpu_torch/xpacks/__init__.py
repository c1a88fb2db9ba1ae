"""Application packs of the port (counterpart of ``pathway_tpu/xpacks/``):
the LLM/RAG toolkit (``llm``) and the enterprise connectors
(``connectors``)."""

from pathway_tpu_torch.xpacks import connectors

__all__ = ["connectors"]
