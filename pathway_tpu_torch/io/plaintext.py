"""Plaintext connector (reference ``python/pathway/io/plaintext``)."""

from __future__ import annotations

from pathway_tpu_torch.io import fs


def read(path, *, mode: str = "streaming", object_pattern: str = "*", with_metadata: bool = False, persistent_id: str | None = None, **kwargs):
    return fs.read(
        path,
        format="plaintext",
        mode=mode,
        with_metadata=with_metadata,
        persistent_id=persistent_id,
        **kwargs,
    )
