"""CSV connector (reference ``python/pathway/io/csv``) — thin wrapper over fs."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs
from pathway_tpu_torch.io._utils import CsvParserSettings


def read(
    path,
    *,
    schema: Any | None = None,
    csv_settings: CsvParserSettings | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    with_metadata: bool = False,
    **kwargs,
):
    return fs.read(
        path,
        format="csv",
        schema=schema,
        csv_settings=csv_settings,
        mode=mode,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        with_metadata=with_metadata,
        **kwargs,
    )


def write(table, filename, **kwargs) -> None:
    fs.write(table, filename, format="csv", **kwargs)
