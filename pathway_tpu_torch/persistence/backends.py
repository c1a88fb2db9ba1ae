"""Persistence backends — key/value blob storage (counterpart of
``pathway_tpu/persistence/backends.py``).

Re-design of the reference's ``PersistenceBackend`` trait
(``src/persistence/backends/{file,memory,s3,mock}.rs``): a flat KV space of
byte blobs with list/remove, used for snapshot-stream chunks and worker
metadata. The file backend writes atomically (tmp + rename) so a crash
mid-write never corrupts a chunk.
"""

from __future__ import annotations

import os
import threading
from typing import Iterable


class PersistenceBackend:
    """Abstract KV blob store (reference ``backends/mod.rs`` trait)."""

    def put_value(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get_value(self, key: str) -> bytes:
        raise NotImplementedError

    def list_keys(self) -> list[str]:
        raise NotImplementedError

    def remove_key(self, key: str) -> None:
        raise NotImplementedError

    def has_key(self, key: str) -> bool:
        return key in self.list_keys()

    def list_prefix(self, prefix: str) -> list[str]:
        return sorted(k for k in self.list_keys() if k.startswith(prefix))


class FilesystemBackend(PersistenceBackend):
    """Blobs as files under a root dir; '/' in keys maps to subdirectories
    (reference ``backends/file.rs``)."""

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.join(self.root, key)
        if os.path.commonpath([os.path.abspath(path), os.path.abspath(self.root)]) != os.path.abspath(self.root):
            raise ValueError(f"key escapes backend root: {key!r}")
        return path

    def put_value(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_value(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def list_keys(self) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                if f.endswith(".tmp"):
                    continue
                out.append(f if rel == "." else os.path.join(rel, f).replace(os.sep, "/"))
        return sorted(out)

    def remove_key(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class MemoryBackend(PersistenceBackend):
    """In-process store. Distinct instances are independent; use
    ``MemoryBackend.shared(name)`` to persist across runs within one process
    (the testing analog of the reference ``backends/memory.rs``)."""

    _shared: dict[str, "MemoryBackend"] = {}
    _shared_lock = threading.Lock()

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    @classmethod
    def shared(cls, name: str) -> "MemoryBackend":
        with cls._shared_lock:
            if name not in cls._shared:
                cls._shared[name] = cls()
            return cls._shared[name]

    def put_value(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def get_value(self, key: str) -> bytes:
        with self._lock:
            return self._data[key]

    def list_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    def remove_key(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class MockBackend(MemoryBackend):
    """Records every operation for test assertions (reference
    ``backends/mock.rs``)."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple[str, str]] = []

    def put_value(self, key, value):
        self.events.append(("put", key))
        super().put_value(key, value)

    def get_value(self, key):
        self.events.append(("get", key))
        return super().get_value(key)

    def remove_key(self, key):
        self.events.append(("remove", key))
        super().remove_key(key)


class S3Backend(PersistenceBackend):
    """S3/MinIO-backed blobs (reference ``backends/s3.rs``). Gated on boto3,
    which is absent here: constructing without it and without an injected
    ``client=`` raises."""

    def __init__(self, bucket: str, prefix: str = "", client=None, **client_kwargs):
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as exc:  # pragma: no cover - env-dependent
                raise ImportError(
                    "S3 persistence backend requires boto3; pass an explicit "
                    "client= or use Backend.filesystem"
                ) from exc
            client = boto3.client("s3", **client_kwargs)
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.client = client

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put_value(self, key, value):
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=value)

    def get_value(self, key):
        resp = self.client.get_object(Bucket=self.bucket, Key=self._key(key))
        return resp["Body"].read()

    def list_keys(self) -> list[str]:
        out: list[str] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": self.prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            for item in resp.get("Contents", []):
                k = item["Key"]
                if self.prefix:
                    k = k[len(self.prefix) + 1 :]
                out.append(k)
            if not resp.get("IsTruncated"):
                return sorted(out)
            token = resp.get("NextContinuationToken")

    def remove_key(self, key):
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))


class AzureBlobBackend(PersistenceBackend):
    """Azure Blob Storage-backed blobs, following the same gated-SDK
    pattern as :class:`S3Backend`: constructing without azure-storage-blob
    raises a clear ImportError instead of silently degrading to a local
    path (users would believe they had durable cloud persistence). Pass an explicit
    ``container_client=`` (anything with upload_blob / download_blob /
    list_blob_names / delete_blob) to use a custom or stub client."""

    def __init__(
        self,
        container: str,
        prefix: str = "",
        container_client=None,
        connection_string: str | None = None,
        account_url: str | None = None,
        credential=None,
        **client_kwargs,
    ):
        if container_client is None:
            try:
                from azure.storage.blob import (  # type: ignore
                    BlobServiceClient,
                )
            except ImportError as exc:  # pragma: no cover - env-dependent
                raise ImportError(
                    "Azure persistence backend requires azure-storage-blob; "
                    "pass an explicit container_client= or use "
                    "Backend.filesystem / Backend.s3"
                ) from exc
            if connection_string is not None:
                service = BlobServiceClient.from_connection_string(
                    connection_string, **client_kwargs
                )
            elif account_url is not None:
                service = BlobServiceClient(
                    account_url, credential=credential, **client_kwargs
                )
            else:
                raise ValueError(
                    "Backend.azure needs connection_string=, account_url=, "
                    "or an explicit container_client="
                )
            container_client = service.get_container_client(container)
        self.container = container
        self.prefix = prefix.strip("/")
        self.client = container_client

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put_value(self, key, value):
        self.client.upload_blob(self._key(key), value, overwrite=True)

    def get_value(self, key):
        return self.client.download_blob(self._key(key)).readall()

    def list_keys(self) -> list[str]:
        out = []
        it = (
            # trailing '/' so a sibling prefix sharing the string prefix
            # ('persist' vs 'persist-old') is never included
            self.client.list_blob_names(name_starts_with=self.prefix + "/")
            if self.prefix
            else self.client.list_blob_names()
        )
        for name in it:
            if self.prefix:
                name = name[len(self.prefix) + 1:]
            out.append(name)
        return sorted(out)

    def remove_key(self, key):
        self.client.delete_blob(self._key(key))
