"""SharePoint reader (counterpart of
``pathway_tpu/xpacks/connectors/sharepoint/``; reference
``python/pathway/xpacks/connectors/sharepoint/__init__.py:255``, licensed):
polls a SharePoint document library over the Office365 REST API, emitting
binary ``data`` rows with change/deletion tracking — built on the same
object-store poller as ``pw.io.gdrive`` / ``pw.io.pyfilesystem``."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._object_store import ObjectStoreConnector


class _SharePointProvider:
    """office365-rest-python-client wrapper; duck-typed ``_client`` with
    ``list_files(root_path, recursive)`` / ``download(server_relative_url)``
    is injectable for offline tests."""

    def __init__(self, client, root_path: str, recursive: bool,
                 object_size_limit: int | None):
        self.client = client
        self.root_path = root_path
        self.recursive = recursive
        self.object_size_limit = object_size_limit

    def list_objects(self) -> dict[str, tuple[Any, dict]]:
        import time as time_mod

        listing: dict[str, tuple[Any, dict]] = {}
        for meta in self.client.list_files(self.root_path, self.recursive):
            size = int(meta.get("size", 0) or 0)
            if self.object_size_limit is not None and size > self.object_size_limit:
                continue
            version = (meta.get("modified_at"), size)
            meta = dict(meta)
            # reference metadata shape (_SharePointEntryMeta.as_dict +
            # url property, sharepoint/__init__.py:29-76)
            base = meta.get("base_url")
            if base and "url" not in meta:
                meta["url"] = f"{base}{meta['path']}"
            meta["seen_at"] = int(time_mod.time())
            meta["status"] = "downloaded"
            listing[meta["path"]] = (version, meta)
        return listing

    def fetch(self, object_id: str) -> bytes:
        return self.client.download(object_id)


def _office365_client(url: str, tenant: str, client_id: str, cert_path: str,
                      thumbprint: str):
    try:
        from office365.sharepoint.client_context import ClientContext  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "pw.xpacks.connectors.sharepoint.read needs "
            "office365-rest-python-client (or pass _client=...)"
        ) from exc

    ctx = ClientContext(url).with_client_certificate(
        tenant, client_id, thumbprint, cert_path
    )

    class _Client:
        def list_files(self, root_path, recursive):
            folder = ctx.web.get_folder_by_server_relative_url(root_path)
            files = folder.get_files(recursive).execute_query()
            return [
                {
                    "path": f.serverRelativeUrl,
                    "name": f.name,
                    "modified_at": str(f.time_last_modified),
                    "size": f.length,
                }
                for f in files
            ]

        def download(self, server_relative_url):
            import io

            buf = io.BytesIO()
            ctx.web.get_file_by_server_relative_url(
                server_relative_url
            ).download(buf).execute_query()
            return buf.getvalue()

    return _Client()


def read(
    url: str = "",
    *,
    tenant: str = "",
    client_id: str = "",
    cert_path: str = "",
    thumbprint: str = "",
    root_path: str = "",
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    max_failed_attempts_in_row: int | None = 8,
    persistent_id: str | None = None,
    _client=None,
) -> Table:
    """Read a SharePoint document library as binary rows. Transient scan
    failures retry up to ``max_failed_attempts_in_row`` consecutive polls
    before propagating (reference behavior). With ``persistent_id``,
    downloads are cached by URI for deterministic replay."""
    client = _client or _office365_client(url, tenant, client_id, cert_path, thumbprint)
    schema = schema_mod.schema_from_types(data=bytes)
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dt.JSON)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"sharepoint({root_path})")
    provider = _SharePointProvider(client, root_path, recursive, object_size_limit)
    conn = ObjectStoreConnector(
        node, provider, mode, with_metadata, float(refresh_interval),
        max_failed_attempts_in_row=max_failed_attempts_in_row,
    )
    G.register_connector(conn)
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return Table(node, schema, Universe())
