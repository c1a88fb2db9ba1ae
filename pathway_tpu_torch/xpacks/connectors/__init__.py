"""Enterprise connectors xpack (counterpart of ``pathway_tpu/xpacks/connectors/``;
reference ``python/pathway/xpacks/connectors``)."""

from pathway_tpu_torch.xpacks.connectors import sharepoint

__all__ = ["sharepoint"]
