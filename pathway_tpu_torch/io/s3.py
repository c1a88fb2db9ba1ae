"""S3 connector (reference ``python/pathway/io/s3`` +
``src/connectors/scanner/s3.rs``).

Real object reading through a boto3 client (gated import — same pattern as
``persistence/backends.py:S3Backend``; tests inject a stub client). The
scanner half lists bucket objects and tracks them by ETag (the S3 analog of
the posix scanner's mtime map); the tokenizer half parses downloaded blobs
with the shared ``iter_records_from_bytes``. A local path (or a mounted
bucket) still goes through the filesystem scanner.
"""

from __future__ import annotations

import time as time_mod
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io import fs
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.io._utils import iter_records_from_bytes


@dataclass
class AwsS3Settings:
    bucket_name: str | None = None
    access_key: str | None = None
    secret_access_key: str | None = None
    with_path_style: bool = False
    region: str | None = None
    endpoint: str | None = None
    # escape hatch for tests / custom stacks: a ready client object with the
    # boto3 surface (list_objects_v2 / get_object)
    client: Any = field(default=None, repr=False, compare=False)

    @classmethod
    def new_from_path(cls, path: str):
        return cls(bucket_name=path)

    def create_client(self):
        """boto3 S3 client for these settings (gated import, like
        ``persistence/backends.py:148``)."""
        if self.client is not None:
            return self.client
        try:
            import boto3  # type: ignore
        except ImportError as exc:
            raise ImportError(
                "reading s3:// paths requires boto3, which is not available "
                "in this environment; mount the bucket and pass a local "
                "path, or supply AwsS3Settings(client=...)"
            ) from exc
        kw: dict[str, Any] = {}
        if self.endpoint:
            kw["endpoint_url"] = self.endpoint
        if self.region:
            kw["region_name"] = self.region
        if self.access_key and self.secret_access_key:
            kw["aws_access_key_id"] = self.access_key
            kw["aws_secret_access_key"] = self.secret_access_key
        if self.with_path_style:
            from botocore.config import Config  # type: ignore

            kw["config"] = Config(s3={"addressing_style": "path"})
        return boto3.client("s3", **kw)


def _split_s3_path(path: str, settings: AwsS3Settings | None) -> tuple[str, str]:
    """(bucket, key prefix) from ``s3://bucket/prefix`` or a bare prefix
    combined with ``settings.bucket_name``."""
    if path.startswith("s3://"):
        rest = path[len("s3://") :]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    if settings is not None and settings.bucket_name:
        return settings.bucket_name, path.lstrip("/")
    raise ValueError(
        f"cannot resolve bucket for {path!r}: use s3://bucket/prefix or set "
        f"AwsS3Settings.bucket_name"
    )


class _S3ScanConnector(BaseConnector):
    """Object scanner: list-by-prefix, detect new/changed objects by ETag,
    download + parse (reference ``scanner/s3.rs:60`` S3Scanner)."""

    shardable = True

    def __init__(self, node, client, bucket: str, prefix: str, fmt: str,
                 schema, mode: str, with_metadata: bool, csv_settings,
                 refresh_interval: float = 1.0, downloader=None):
        super().__init__(node)
        self.client = client
        self.bucket = bucket
        self.prefix = prefix
        self.fmt = fmt
        self.schema = schema
        self.mode = mode
        self.with_metadata = with_metadata
        self.csv_settings = csv_settings
        self.refresh_interval = refresh_interval
        self._seen: dict[str, str] = {}  # object key -> etag
        self._emitted_pk: dict[int, tuple] = {}
        # object key -> {row key: row its current content provides}, so
        # ETag changes and deletions retract stale rows (reference
        # ``scanner/s3.rs`` emits Update/Delete actions, not blind re-adds)
        self._obj_rows: dict[str, dict[int, tuple]] = {}
        # pk row key -> object whose value is live (several objects can
        # carry the same pk; deleting a non-owner must not retract, and
        # deleting the owner falls back to another source's value)
        self._row_owner: dict[int, str] = {}
        self._replayed_rows: dict[int, tuple] = {}
        self._sought: dict | None = None
        if mode != "static":
            self.heartbeat_ms = 500

    # persistence offset = the seen map (key -> etag) plus enough to rebuild
    # _obj_rows from replayed row payloads. Non-pk row keys are hash(uri, i)
    # with i contiguous, so a per-object COUNT suffices — O(objects), not
    # O(rows). Pk objects store their row-key lists (pk upsert sources are
    # keyed data, typically far smaller than raw logs).
    def current_offset(self):
        if self.schema.primary_key_columns():
            return {
                "seen": dict(self._seen),
                "obj_rows": {k: list(v) for k, v in self._obj_rows.items()},
                "owner": dict(self._row_owner),
            }
        return {
            "seen": dict(self._seen),
            "counts": {k: len(v) for k, v in self._obj_rows.items()},
        }

    def seek_offset(self, offset) -> None:
        if not isinstance(offset, dict):
            return
        if "seen" not in offset:  # legacy format: plain key -> etag map
            self._seen.update(offset)
            return
        self._seen.update(offset["seen"])
        self._row_owner.update(offset.get("owner", {}))
        self._sought = offset
        self._rebuild_obj_rows()

    def _rebuild_obj_rows(self) -> None:
        """``_obj_rows`` from the sought offset and the replayed rows. The
        runtime seeks before ``on_replay`` (JAX: after it): both hooks call
        this, and it acts once both have run."""
        offset = self._sought
        if offset is None or not self._replayed_rows:
            return
        for obj_key, row_keys in offset.get("obj_rows", {}).items():
            # NB: replay carries the LIVE value per pk; a non-owner source
            # whose copy differed is restored with the live value until its
            # ETag next changes — fallback then re-emits a no-op, which is
            # consistent, just not byte-faithful to the non-owner's content
            live = self._obj_rows.setdefault(obj_key, {})
            for rk in row_keys:
                row = self._replayed_rows.get(rk)
                if row is not None:
                    live[rk] = row
        for obj_key, count in offset.get("counts", {}).items():
            uri = f"s3://{self.bucket}/{obj_key}"
            live = self._obj_rows.setdefault(obj_key, {})
            for i in range(count):
                rk = hash_values(uri, i)
                row = self._replayed_rows.get(rk)
                if row is not None:
                    live[rk] = row

    def on_replay(self, rows) -> None:
        pk = bool(self.schema.primary_key_columns())
        for key, row, diff in rows:
            if diff > 0:
                self._replayed_rows[key] = row
                if pk:
                    self._emitted_pk[key] = row
            else:
                self._replayed_rows.pop(key, None)
                if pk:
                    self._emitted_pk.pop(key, None)
        self._rebuild_obj_rows()

    def _list_objects(self) -> list[dict]:
        out: list[dict] = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": self.prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            out.extend(resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                return out
            token = resp.get("NextContinuationToken")

    def _parse_object(self, obj: dict, body: bytes, uri: str,
                      pk, cols, n_proc: int, pid: int) -> dict[int, tuple]:
        """Parse one downloaded blob into {row key: row} after shard
        filtering; keys are pk hashes or (uri, index) hashes."""
        from pathway_tpu_torch.engine.value import shard_of_key

        meta = None
        if self.with_metadata:
            meta = Json(
                {
                    "path": uri,
                    "size": int(obj.get("Size", len(body))),
                    "seen_at": int(time_mod.time()),
                }
            )
        new_rows: dict[int, tuple] = {}
        for i, values in enumerate(
            iter_records_from_bytes(body, self.fmt, self.schema, self.csv_settings)
        ):
            if self.with_metadata:
                values = {**values, "_metadata": meta}
            row = tuple(values[c] for c in cols)
            if pk:
                key = hash_values(*[values[c] for c in pk])
                if n_proc > 1 and shard_of_key(key, n_proc) != pid:
                    continue
            else:
                key = hash_values(uri, i)
            new_rows[key] = row
        return new_rows

    def _diff_object(self, key_name: str, new_rows: dict[int, tuple],
                     pk) -> list[tuple[int, tuple, int]]:
        """Deltas that move this object's contribution from its previous
        parse to ``new_rows`` — retracting dropped/changed rows the way the
        reference scanner emits Update/Delete actions."""
        deltas: list[tuple[int, tuple, int]] = []
        old_rows = self._obj_rows.get(key_name, {})
        live: dict[int, tuple] = {}
        if pk:
            for key, row in new_rows.items():
                old = self._emitted_pk.get(key)
                if old != row:
                    # new or changed value: this object's write wins
                    if old is not None:
                        deltas.append((key, old, -1))
                    deltas.append((key, row, 1))
                    self._emitted_pk[key] = row
                    self._row_owner[key] = key_name
                elif key not in self._row_owner:
                    self._row_owner[key] = key_name
                # old == row with another owner: an extra source for the
                # same value — record it in `live`, leave ownership alone
                live[key] = row
            self._set_live(key_name, live)
            for key, old in old_rows.items():
                if key in new_rows:
                    continue  # still produced here
                if self._row_owner.get(key) != key_name:
                    continue  # live value owned by another object
                self._drop_or_failover(key, key_name, deltas)
            return deltas
        else:
            for key, row in new_rows.items():
                old = old_rows.get(key)
                if old == row:
                    live[key] = row
                    continue
                if old is not None:
                    deltas.append((key, old, -1))
                deltas.append((key, row, 1))
                live[key] = row
            for key, old in old_rows.items():
                if key not in new_rows:
                    deltas.append((key, old, -1))
        self._set_live(key_name, live)
        return deltas

    def _set_live(self, key_name: str, live: dict[int, tuple]) -> None:
        if live:
            self._obj_rows[key_name] = live
        else:
            self._obj_rows.pop(key_name, None)

    def _drop_or_failover(self, key: int, key_name: str,
                          deltas: list[tuple[int, tuple, int]]) -> None:
        """The owning object stopped providing pk ``key``: hand the live
        value over to another object still carrying it, else retract."""
        cur = self._emitted_pk.get(key)
        for obj2, rows2 in self._obj_rows.items():
            if obj2 == key_name:
                continue
            val2 = rows2.get(key)
            if val2 is None:
                continue
            if val2 != cur and cur is not None:
                deltas.append((key, cur, -1))
                deltas.append((key, val2, 1))
                self._emitted_pk[key] = val2
            self._row_owner[key] = obj2
            return
        self._row_owner.pop(key, None)
        if self._emitted_pk.pop(key, None) is not None:
            deltas.append((key, cur, -1))

    def _read_new(self) -> list[tuple[int, tuple, int]]:
        from pathway_tpu_torch.internals import config as config_mod
        from pathway_tpu_torch.engine.value import shard_of_key

        cfg = config_mod.active()
        n_proc, pid = cfg.processes, cfg.process_id
        cols = list(self.node.column_names)
        pk = self.schema.primary_key_columns()
        rows: list[tuple[int, tuple, int]] = []
        listed: set[str] = set()
        for obj in self._list_objects():
            key_name = obj["Key"]
            if key_name.endswith("/"):
                continue  # folder marker
            uri = f"s3://{self.bucket}/{key_name}"
            if (
                n_proc > 1
                and not pk
                and shard_of_key(hash_values(uri), n_proc) != pid
            ):
                continue
            listed.add(key_name)
            etag = str(obj.get("ETag", obj.get("LastModified", "")))
            if self._seen.get(key_name) == etag:
                continue
            try:
                body = self.client.get_object(
                    Bucket=self.bucket, Key=key_name
                )["Body"].read()
            except Exception as exc:  # noqa: BLE001
                # vanished between list and get, or a transient S3 error —
                # skip (NOT marked seen, so the next scan retries); one bad
                # object must not kill the stream
                from pathway_tpu_torch.internals.errors import get_global_error_log

                get_global_error_log().log(f"s3: fetch {uri} failed: {exc!r}")
                continue
            self._seen[key_name] = etag
            new_rows = self._parse_object(obj, body, uri, pk, cols, n_proc, pid)
            rows.extend(self._diff_object(key_name, new_rows, pk))
        # objects gone from the bucket: retract everything they contributed
        for key_name in list(self._seen):
            if key_name in listed:
                continue
            del self._seen[key_name]
            rows.extend(self._diff_object(key_name, {}, pk))
        return rows

    def run(self):
        rows = self._read_new()
        if rows or self._persistence is None:
            self.commit_rows(rows)
        if self.mode == "static":
            return
        while not self.should_stop():
            time_mod.sleep(self.refresh_interval)
            rows = self._read_new()
            if rows:
                self.commit_rows(rows)


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "csv",  # noqa: A002
    schema: Any | None = None,
    mode: str = "streaming",
    csv_settings=None,
    with_metadata: bool = False,
    persistent_id: str | None = None,
    refresh_interval: float = 1.0,
    **kwargs,
):
    if path.startswith("s3://") or (
        aws_s3_settings is not None and aws_s3_settings.bucket_name
        and not path.startswith(("/", "./"))
    ):
        bucket, prefix = _split_s3_path(path, aws_s3_settings)
        client = (aws_s3_settings or AwsS3Settings()).create_client()
        if format in ("plaintext", "plaintext_by_file"):
            schema = schema_mod.schema_from_types(data=str)
        elif format == "binary":
            schema = schema_mod.schema_from_types(data=bytes)
        elif schema is None:
            raise ValueError("schema is required for csv/json formats")
        if with_metadata:
            from pathway_tpu_torch.internals import dtype as dt

            schema = schema | schema_mod.schema_from_types(_metadata=dt.JSON)
        cols = list(schema.column_names())
        node = InputNode(G.engine_graph, cols, name=f"s3({bucket}/{prefix})")
        conn = _S3ScanConnector(
            node, client, bucket, prefix, format, schema, mode,
            with_metadata, csv_settings, refresh_interval,
        )
        G.register_connector(conn)
        table = Table(node, schema, Universe())
        if persistent_id is not None:
            from pathway_tpu_torch.persistence import register_persistent_source

            register_persistent_source(persistent_id, conn)
        return table
    return fs.read(
        path, format=format, schema=schema, mode=mode,
        csv_settings=csv_settings, with_metadata=with_metadata,
        persistent_id=persistent_id, refresh_interval=refresh_interval,
        **kwargs,
    )


read_from_csv = read


class _VendorS3Settings:
    """Shared shape of third-party S3-compatible vendor settings; subclasses
    set ``_ENDPOINT_TEMPLATE`` (reference ``io/s3/__init__.py:22,57``)."""

    _ENDPOINT_TEMPLATE: str | None = None

    def __init__(self, bucket_name=None, *, access_key=None,
                 secret_access_key=None, region=None):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region

    def _to_aws(self) -> AwsS3Settings:
        endpoint = (
            self._ENDPOINT_TEMPLATE.format(region=self.region)
            if self.region and self._ENDPOINT_TEMPLATE
            else None
        )
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            region=self.region,
            endpoint=endpoint,
        )


class DigitalOceanS3Settings(_VendorS3Settings):
    """Digital Ocean Spaces connection settings."""

    _ENDPOINT_TEMPLATE = "https://{region}.digitaloceanspaces.com"


class WasabiS3Settings(_VendorS3Settings):
    """Wasabi S3 connection settings."""

    _ENDPOINT_TEMPLATE = "https://s3.{region}.wasabisys.com"


def read_from_digital_ocean(path: str, do_s3_settings: DigitalOceanS3Settings,
                            format: str, **kwargs):  # noqa: A002
    """Read from a Digital Ocean Spaces bucket (reference
    ``io/s3/__init__.py:304``)."""
    return read(path, aws_s3_settings=do_s3_settings._to_aws(),
                format=format, **kwargs)


def read_from_wasabi(path: str, wasabi_s3_settings: WasabiS3Settings,
                     format: str, **kwargs):  # noqa: A002
    """Read from a Wasabi S3 bucket (reference ``io/s3/__init__.py:366``)."""
    return read(path, aws_s3_settings=wasabi_s3_settings._to_aws(),
                format=format, **kwargs)
