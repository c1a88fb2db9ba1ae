"""Google Drive reader (reference ``python/pathway/io/gdrive/__init__.py:336``):
polls a Drive directory/file by object id via a service account, emitting
each file as a binary ``data`` column (optional ``_metadata``), with
new/changed/deleted detection every ``refresh_interval`` seconds."""

from __future__ import annotations

import fnmatch
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._object_store import ObjectStoreConnector

_FOLDER_MIME = "application/vnd.google-apps.folder"

# Google-Workspace types cannot be downloaded raw; they EXPORT to office
# formats (reference ``io/gdrive/__init__.py:35`` DEFAULT_MIME_TYPE_MAPPING)
DEFAULT_MIME_TYPE_MAPPING: dict[str, str] = {
    "application/vnd.google-apps.document":
        "application/vnd.openxmlformats-officedocument"
        ".wordprocessingml.document",
    "application/vnd.google-apps.spreadsheet":
        "application/vnd.openxmlformats-officedocument"
        ".spreadsheetml.sheet",
    "application/vnd.google-apps.presentation":
        "application/vnd.openxmlformats-officedocument"
        ".presentationml.presentation",
}


def _is_transient(exc: Exception) -> bool:
    """Retry genuine service weather only: 5xx/429, 403 rate limits, and
    network-level errors. Auth/permission/404 errors surface immediately."""
    status = getattr(getattr(exc, "resp", None), "status", None)
    if status in (429, 500, 502, 503, 504):
        return True
    if status == 403:
        # rate-limit 403s carry a reason; permission 403s must raise
        text = str(exc).lower()
        return "ratelimit" in text or "rate limit" in text or (
            "quota" in text
        )
    if status is None:
        return isinstance(exc, (ConnectionError, OSError, TimeoutError))
    return False


def _retrying(call, retries: int = 5, base_delay: float = 0.5):
    """Execute a Drive API request with exponential backoff on transient
    failures (the normal weather of the real service)."""
    import time as time_mod

    for attempt in range(retries):
        try:
            return call()
        except Exception as exc:  # noqa: BLE001 - HttpError shape is gated
            if not _is_transient(exc) or attempt == retries - 1:
                raise
            time_mod.sleep(base_delay * (2 ** attempt))


class _GDriveClient:
    """Thin googleapiclient wrapper (files().list / get_media /
    export_media) with shared-drive support and retrying calls."""

    def __init__(self, credentials_file: str,
                 export_type_mapping: dict[str, str] | None = None):
        try:
            from google.oauth2.service_account import Credentials
            from googleapiclient.discovery import build
        except ImportError as exc:
            raise ImportError(
                "pw.io.gdrive.read needs google-api-python-client (or pass "
                "_client=... with list_files/download methods)"
            ) from exc
        creds = Credentials.from_service_account_file(
            credentials_file, scopes=["https://www.googleapis.com/auth/drive.readonly"]
        )
        self._service = build("drive", "v3", credentials=creds)
        self.export_type_mapping = (
            DEFAULT_MIME_TYPE_MAPPING
            if export_type_mapping is None
            else export_type_mapping
        )

    def list_files(self, object_id: str) -> list[dict]:
        """Flat recursive listing of ``object_id`` (file or folder);
        shared drives included (supportsAllDrives, reference behavior)."""
        fields = "id, name, mimeType, parents, modifiedTime, size, trashed"
        root = _retrying(
            self._service.files()
            .get(fileId=object_id, fields=fields, supportsAllDrives=True)
            .execute
        )
        if root.get("mimeType") != _FOLDER_MIME:
            # files().get succeeds for trashed files (only the child query
            # filters them) — a trashed single-file source must retract
            return [] if root.get("trashed") else [root]
        out: list[dict] = []
        queue = [object_id]
        while queue:
            folder = queue.pop()
            page_token = None
            while True:
                resp = _retrying(
                    self._service.files()
                    .list(
                        q=f"'{folder}' in parents and trashed = false",
                        fields=f"nextPageToken, files({fields})",
                        pageToken=page_token,
                        supportsAllDrives=True,
                        includeItemsFromAllDrives=True,
                    )
                    .execute
                )
                for f in resp.get("files", []):
                    if f.get("trashed"):
                        continue
                    if f.get("mimeType") == _FOLDER_MIME:
                        queue.append(f["id"])
                    else:
                        out.append(f)
                page_token = resp.get("nextPageToken")
                if page_token is None:
                    break
        return out

    def download(self, file_id: str, mime_type: str | None = None) -> bytes:
        """Raw download, or office-format EXPORT for Google-Workspace
        types (get_media raises on them; reference
        ``_prepare_download_request``, io/gdrive/__init__.py:196)."""
        export_type = (
            self.export_type_mapping.get(mime_type) if mime_type else None
        )
        if export_type is not None:
            req = self._service.files().export_media(
                fileId=file_id, mimeType=export_type
            )
        else:
            # supportsAllDrives: listings include shared-drive items, so
            # downloads must be able to reach them too
            req = self._service.files().get_media(
                fileId=file_id, supportsAllDrives=True
            )
        return _retrying(req.execute)


class _GDriveProvider:
    def __init__(self, client, object_id: str, object_size_limit: int | None,
                 file_name_pattern):
        self.client = client
        self.object_id = object_id
        self.object_size_limit = object_size_limit
        if isinstance(file_name_pattern, str):
            file_name_pattern = [file_name_pattern]
        self.file_name_pattern = file_name_pattern
        self._mime_of: dict[str, str | None] = {}
        # legacy injected clients have download(file_id) without the
        # mime_type kwarg — detect ONCE (a per-fetch TypeError probe would
        # mask genuine TypeErrors and double-download)
        import inspect

        try:
            sig = inspect.signature(client.download)
            self._download_takes_mime = "mime_type" in sig.parameters
        except (TypeError, ValueError):
            self._download_takes_mime = True

    def list_objects(self) -> dict[str, tuple[Any, dict]]:
        import time as time_mod

        listing: dict[str, tuple[Any, dict]] = {}
        mimes: dict[str, str | None] = {}
        for meta in self.client.list_files(self.object_id):
            size = int(meta.get("size", 0) or 0)
            if self.object_size_limit is not None and size > self.object_size_limit:
                continue
            name = meta.get("name", "")
            if self.file_name_pattern is not None and not any(
                fnmatch.fnmatch(name, p) for p in self.file_name_pattern
            ):
                continue
            version = (meta.get("modifiedTime"), size)
            meta = dict(meta)
            # enriched metadata (reference extend_metadata,
            # io/gdrive/__init__.py:44-70): a browse url, a path (the file
            # name — Drive paths are id-graphs, names are the usable part),
            # and the poll timestamp
            meta.setdefault(
                "url", f"https://drive.google.com/file/d/{meta['id']}/"
            )
            meta.setdefault("path", name)
            meta["seen_at"] = int(time_mod.time())
            meta["status"] = "downloaded"
            mimes[meta["id"]] = meta.get("mimeType")
            listing[meta["id"]] = (version, meta)
        # rebuilt per scan: bounded by the LIVE set (high-churn folders
        # would otherwise grow this for the process lifetime)
        self._mime_of = mimes
        return listing

    def fetch(self, object_id: str) -> bytes:
        if not self._download_takes_mime:
            return self.client.download(object_id)
        return self.client.download(
            object_id, mime_type=self._mime_of.get(object_id)
        )


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    refresh_interval: int = 30,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    file_name_pattern: list | str | None = None,
    max_failed_attempts_in_row: int | None = 8,
    persistent_id: str | None = None,
    _client=None,
) -> Table:
    """Read a Drive file/folder (recursively) as binary rows. ``_client``
    (duck-typed ``list_files``/``download``) is injectable for offline
    tests. Transient scan failures retry up to
    ``max_failed_attempts_in_row`` consecutive polls before propagating.
    With ``persistent_id``, downloads are cached by URI for deterministic
    replay."""
    client = _client or _GDriveClient(service_user_credentials_file)
    schema = schema_mod.schema_from_types(data=bytes)
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dt.JSON)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"gdrive({object_id})")
    provider = _GDriveProvider(client, object_id, object_size_limit, file_name_pattern)
    conn = ObjectStoreConnector(
        node, provider, mode, with_metadata, float(refresh_interval),
        max_failed_attempts_in_row=max_failed_attempts_in_row,
    )
    G.register_connector(conn)
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(persistent_id, conn)
    return Table(node, schema, Universe())
