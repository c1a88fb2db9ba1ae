"""BigQuery sink (reference ``python/pathway/io/bigquery/__init__.py:55-103``:
buffers one minibatch per logical time, then ``insert_rows_json`` with
``time``/``diff`` annotation columns)."""

from __future__ import annotations

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import format_value_for_output


class _OutputBuffer:
    def __init__(self, client, dataset_name: str, table_name: str, cols):
        self.client = client
        self.table_ref = f"{dataset_name}.{table_name}"
        self.cols = cols

    def __call__(self, time, batch) -> None:
        rows = []
        for _key, row, diff in batch.rows():
            payload = {
                c: format_value_for_output(v) for c, v in zip(self.cols, row)
            }
            payload["time"] = time
            payload["diff"] = diff
            rows.append(payload)
        if rows:
            errors = self.client.insert_rows_json(self.table_ref, rows)
            if errors:
                raise RuntimeError(f"BigQuery insert errors: {errors}")


def write(
    table: Table,
    dataset_name: str,
    table_name: str,
    service_user_credentials_file: str | None = None,
    *,
    _client=None,
) -> None:
    """Write ``table``'s change stream into ``dataset_name.table_name``. The
    target schema must extend the table's schema with integral ``time`` and
    ``diff`` columns. ``_client`` (duck-typed ``insert_rows_json``) is
    injectable for offline tests."""
    client = _client
    if client is None:
        try:
            from google.cloud import bigquery  # type: ignore[import-not-found]
            from google.oauth2.service_account import (  # type: ignore[import-not-found]
                Credentials as ServiceCredentials,
            )
        except ImportError as exc:
            raise ImportError(
                "pw.io.bigquery.write needs google-cloud-bigquery (or pass "
                "_client=... for a preconfigured client)"
            ) from exc
        credentials = ServiceCredentials.from_service_account_file(
            service_user_credentials_file
        )
        client = bigquery.Client(credentials=credentials)
    buffer = _OutputBuffer(client, dataset_name, table_name, table.column_names())
    node = SinkNode(
        G.engine_graph, table._node, buffer,
        name=f"bigquery({dataset_name}.{table_name})",
    )
    G.register_sink(node)
