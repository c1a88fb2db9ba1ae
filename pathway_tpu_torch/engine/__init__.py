"""Host-side engine pieces of the port: the prefix-cache radix tree and
its host tier, the bounded stage worker, the metrics registry and its
ledgers (``probes``), the request spans (``tracing``), the SLO watchdog
and degradation ladder (``slo``) and the fault injection sites
(``chaos``)."""

from pathway_tpu_torch.engine import probes, tracing

__all__ = ["probes", "tracing"]
