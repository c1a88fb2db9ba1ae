"""``pw.utils`` helpers (counterpart of ``pathway_tpu/stdlib/utils/``,
reference ``python/pathway/stdlib/utils/``)."""

from pathway_tpu_torch.stdlib.utils import bucketing, col, filtering
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer

__all__ = ["AsyncTransformer", "pandas_transformer", "bucketing", "col", "filtering"]
