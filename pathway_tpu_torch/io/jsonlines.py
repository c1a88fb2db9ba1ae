"""JSON-lines connector (reference ``python/pathway/io/jsonlines``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


def read(
    path,
    *,
    schema: Any | None = None,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    with_metadata: bool = False,
    **kwargs,
):
    return fs.read(
        path,
        format="json",
        schema=schema,
        mode=mode,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        with_metadata=with_metadata,
        **kwargs,
    )


def write(table, filename, **kwargs) -> None:
    fs.write(table, filename, format="json", **kwargs)
