"""PyFilesystem reader (reference ``python/pathway/io/pyfilesystem/__init__.py:142``):
ingest any `fs.FS <https://docs.pyfilesystem.org>`_ source (zip, ftp, mem,
osfs, ...) as a binary ``data`` column with optional ``_metadata``, polling
for new/changed/deleted files in streaming mode."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._object_store import ObjectStoreConnector


class _PyFsProvider:
    """Adapter over an ``fs.FS``-like object (``walk.files``/``listdir``,
    ``getinfo``, ``readbytes``)."""

    def __init__(self, source, path: str):
        self.source = source
        self.path = path or "/"

    def _files(self) -> list[str]:
        walk = getattr(self.source, "walk", None)
        if walk is not None:
            return list(walk.files(self.path))
        out: list[str] = []

        def rec(p: str) -> None:
            for entry in self.source.listdir(p):
                full = p.rstrip("/") + "/" + entry
                if self.source.isdir(full):
                    rec(full)
                else:
                    out.append(full)

        rec(self.path)
        return out

    def list_objects(self) -> dict[str, tuple[Any, dict]]:
        listing: dict[str, tuple[Any, dict]] = {}
        for path in self._files():
            try:
                info = self.source.getinfo(path, namespaces=["details"])
            except Exception:
                continue
            modified = getattr(info, "modified", None)
            size = getattr(info, "size", None)
            version = (str(modified), size)
            listing[path] = (
                version,
                {
                    "path": path,
                    "name": getattr(info, "name", path.rsplit("/", 1)[-1]),
                    "modified_at": str(modified) if modified else None,
                    "size": size,
                },
            )
        return listing

    def fetch(self, object_id: str) -> bytes:
        reader = getattr(self.source, "readbytes", None) or getattr(
            self.source, "getbytes"
        )
        return reader(object_id)


def read(
    source,
    *,
    path: str = "",
    refresh_interval: float = 30,
    mode: str = "streaming",
    with_metadata: bool = False,
    persistent_id: str | None = None,
    _provider=None,
) -> Table:
    """Read every file under ``path`` of the PyFilesystem ``source`` into a
    single binary ``data`` column (plus ``_metadata`` when requested).
    With ``persistent_id``, downloaded objects are cached by URI in the
    persistence backend so restarts replay deterministically. ``_provider``
    (duck-typed ``list_objects``/``fetch``) is injectable for offline
    tests."""
    schema = schema_mod.schema_from_types(data=bytes)
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dt.JSON)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"pyfilesystem({path or '/'})")
    conn = ObjectStoreConnector(
        node, _provider or _PyFsProvider(source, path), mode, with_metadata,
        refresh_interval,
    )
    G.register_connector(conn)
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return Table(node, schema, Universe())
