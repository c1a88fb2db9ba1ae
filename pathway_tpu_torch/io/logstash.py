"""Logstash sink — HTTP-input-plugin wrapper (reference
``python/pathway/io/logstash/__init__.py:14-70``: delegates to
``pw.io.http.write`` against the Logstash HTTP input endpoint)."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import RetryPolicy
from pathway_tpu_torch.io.http import write as http_write


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    **kwargs,
) -> None:
    """Stream ``table`` changes into the Logstash ``http`` input at
    ``endpoint``."""
    http_write(
        table,
        endpoint,
        n_retries=n_retries,
        retry_policy=retry_policy or RetryPolicy.default(),
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
        **kwargs,
    )
