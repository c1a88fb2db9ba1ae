"""The port's object-store readers and thin connectors held against the
JAX package with JAX's own fakes and stubs.

``io/_object_store.py`` under ``pyfilesystem`` and ``gdrive``
(``tests/test_io_backends.py:145-220``, ``:543-650``), the S3 scanner with
``s3_csv``, ``minio`` and the vendor settings
(``tests/test_real_backends.py:263-521``, ``:748``), the sinks of
``tests/test_io_writers_matrix.py`` and ``tests/test_io_backends.py:19-140``
(``postgres`` through a ``sqlite3`` connection factory, ``mongodb``,
``elasticsearch``, ``nats``, ``bigquery``, ``pubsub``, ``logstash``,
``slack``), the stubbed ``nats`` subscription and the ``redpanda`` alias.
Each case runs the same program or scanner through both packages: the row
ids must be equal (the port hashes with its XXH64, JAX with its own), the
rows and the deltas equal, and what a sink received equal. A client
package that is absent raises the same clear ``ImportError`` in both.
Every wait is bounded."""

from __future__ import annotations

import asyncio
import json
import sqlite3
import sys
import threading
import time
import types

import pytest

from tests.test_io_backends import FakeDrive, FakeFS
from tests.test_real_backends import _DictProvider, _StubS3Client
from tests.torch_engine import PACKAGES, PW, canon, final_state

pytestmark = pytest.mark.timeout(120)

WAIT = 20.0  # a bound on each wait of a streaming case


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pw in PW.values():
        pw.clear_graph()


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def _both(build):
    """The final state of ``build(pw)`` in each package; equal."""
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = final_state(pkg, build(PW[pkg]))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _word(pw):
    class WordSchema(pw.Schema):
        word: str

    return WordSchema


def _pk_word(pw):
    class PkWord(pw.Schema):
        word: str = pw.column_definition(primary_key=True)
        n: int

    return PkWord


def _jsonl(*words):
    return "".join(json.dumps({"word": w}) + "\n" for w in words).encode()


def _pk_jsonl(*pairs):
    return "".join(json.dumps({"word": w, "n": n}) + "\n" for w, n in pairs).encode()


def _stream(pkg, build, done, feed=None, timeout=WAIT):
    """Subscribe to ``build(pw)``'s table in a streaming run; ``feed`` runs
    beside it; the run's connectors stop once ``done(events)``. Returns the
    ``(row id, row, is_addition)`` events in order."""
    pw = PW[pkg]
    pw.clear_graph()
    t = build(pw)
    events, lock = [], threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            events.append((key.value, tuple(canon(v) for v in row.values()), is_addition))

    pw.io.subscribe(t, on_change=on_change)
    conns = list(pw.G.connectors)

    def feeder():
        deadline = time.time() + timeout
        try:
            if feed is not None:
                feed(lambda n: _wait(lambda: len(events) >= n, deadline))
            _wait(lambda: done(list(events)), deadline)
        finally:
            for c in conns:
                c._stop.set()
                c.close()

    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    pw.run()
    th.join(timeout)
    assert not th.is_alive(), "the feeder did not finish"
    return events


def _wait(cond, deadline):
    while time.time() < deadline and not cond():
        time.sleep(0.02)


# ------------------------------------------------------ object-store readers
def test_pyfilesystem_read_static():
    source = FakeFS({"/docs/a.txt": b"hello", "/docs/b.txt": b"world"})
    rows, cols = _both(lambda pw: pw.io.pyfilesystem.read(
        source, path="/docs", mode="static", with_metadata=True))
    assert sorted(r[cols.index("data")] for r in rows.values()) == [b"hello", b"world"]


def test_gdrive_read_with_size_limit_and_pattern():
    rows, cols = _both(lambda pw: pw.io.gdrive.read(
        "folder-id", mode="static", object_size_limit=1000, with_metadata=True,
        file_name_pattern="*.txt", _client=FakeDrive()))
    (row,) = rows.values()
    assert row[cols.index("data")] == b"xxxxx"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gdrive_workspace_export_and_metadata(pkg):
    """Workspace files are exported through the MIME mapping; the metadata
    carries the url, path, status and poll time (JAX's case)."""
    pw = PW[pkg]
    from importlib import import_module

    mapping = import_module(f"{pw.__name__}.io.gdrive").DEFAULT_MIME_TYPE_MAPPING
    unwrap = import_module(f"{pw.__name__}.internals.json").unwrap_json
    doc_mime = "application/vnd.google-apps.document"

    class ExportingDrive:
        def __init__(self):
            self.calls = []
            self.files = {
                "gdoc1": {"id": "gdoc1", "name": "notes.gdoc", "mimeType": doc_mime,
                          "modifiedTime": "2026-01-01T00:00:00Z", "size": "0"},
                "raw1": {"id": "raw1", "name": "a.txt", "mimeType": "text/plain",
                         "modifiedTime": "2026-01-01T00:00:00Z", "size": "3"},
            }

        def list_files(self, object_id):
            return list(self.files.values())

        def download(self, file_id, mime_type=None):
            self.calls.append((file_id, mime_type))
            return b"exported-docx" if mime_type in mapping else b"raw"

    drive = ExportingDrive()
    pw.clear_graph()
    t = pw.io.gdrive.read("folder", mode="static", with_metadata=True, _client=drive)
    cap = pw.debug.table_to_dicts(t)[1]
    by_name = {}
    for k in cap["data"]:
        meta = unwrap(cap["_metadata"][k])
        by_name[meta["name"]] = (cap["data"][k], meta)
    data, meta = by_name["notes.gdoc"]
    assert data == b"exported-docx" and meta["path"] == "notes.gdoc"
    assert meta["url"].startswith("https://drive.google.com/file/d/gdoc1")
    assert meta["status"] == "downloaded" and "seen_at" in meta
    assert ("gdoc1", doc_mime) in drive.calls and by_name["a.txt"][0] == b"raw"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_object_store_scan_failure_tolerance(pkg):
    """Two failed listings mid-stream are retried; the stream goes on and
    sees an object added after them."""
    from importlib import import_module

    pw = PW[pkg]
    mods = {n: import_module(f"{pw.__name__}.{n}") for n in (
        "engine.operators.core", "io._object_store", "internals.table",
        "internals.universe", "internals.schema")}

    class FlakyProvider:
        def __init__(self):
            self.calls = 0
            self.objects = {"a": (1, {"path": "a"})}

        def list_objects(self):
            self.calls += 1
            if self.calls in (2, 3):
                raise ConnectionError("remote hiccup")
            return dict(self.objects)

        def fetch(self, oid):
            return b"payload-" + oid.encode()

    provider = FlakyProvider()

    def build(pw):
        node = mods["engine.operators.core"].InputNode(pw.G.engine_graph, ["data"],
                                                        name="flaky")
        conn = mods["io._object_store"].ObjectStoreConnector(
            node, provider, "streaming", False, 0.05, max_failed_attempts_in_row=8)
        pw.G.register_connector(conn)
        return mods["internals.table"].Table(
            node, mods["internals.schema"].schema_from_types(data=bytes),
            mods["internals.universe"].Universe())

    def feed(wait_for):
        wait_for(1)
        deadline = time.time() + WAIT
        _wait(lambda: provider.calls >= 5, deadline)
        provider.objects["b"] = (1, {"path": "b"})

    events = _stream(pkg, build, lambda ev: len(ev) >= 2, feed)
    assert provider.calls >= 5
    assert sorted(r for _k, r, _a in events) == [(b"payload-a",), (b"payload-b",)]


def test_object_store_keys_equal_across_packages():
    """A changed and a deleted object retract under the same row ids."""
    deltas = {}
    for pkg in PACKAGES:
        from importlib import import_module

        pw = PW[pkg]
        pw.clear_graph()
        mod = import_module(f"{pw.__name__}.io._object_store")
        core = import_module(f"{pw.__name__}.engine.operators.core")
        provider = _DictProvider({"a": (1, b"alpha"), "b": (1, b"beta")})
        conn = mod.ObjectStoreConnector(core.InputNode(pw.G.engine_graph, ["data"]),
                                        provider, "static", False, 1.0)
        first = conn._scan()
        provider.objects["a"] = (2, b"alpha2")
        del provider.objects["b"]
        deltas[pkg] = (first, conn._scan(), conn.current_offset())
    assert deltas["torch"] == deltas["jax"]
    first, second, offset = deltas["torch"]
    assert sorted((r, d) for _k, r, d in second) == [
        ((b"alpha",), -1), ((b"alpha2",), 1), ((b"beta",), -1)]
    assert offset == {"a": 2}


@pytest.mark.parametrize("order", ["port", "jax"])
def test_object_store_rebuild_does_not_depend_on_hook_order(order):
    """The port seeks before ``on_replay``, JAX after: either order
    rebuilds the live map, so a restart re-emits nothing and still retracts
    a removed object."""
    import pathway_tpu_torch as TPW
    from pathway_tpu_torch.engine.operators.core import InputNode
    from pathway_tpu_torch.engine.value import hash_values
    from pathway_tpu_torch.io._object_store import ObjectStoreConnector

    TPW.clear_graph()
    provider = _DictProvider({"a": (1, b"alpha"), "b": (1, b"beta")})
    conn = ObjectStoreConnector(InputNode(TPW.G.engine_graph, ["data"]), provider,
                                "static", False, 1.0)
    rows = [(hash_values("a"), (b"alpha",), 1), (hash_values("b"), (b"beta",), 1)]
    offset = {"a": 1, "b": 1}
    if order == "port":
        conn.seek_offset(offset)
        conn.on_replay(rows)
    else:
        conn.on_replay(rows)
        conn.seek_offset(offset)
    assert conn._scan() == []
    del provider.objects["b"]
    assert conn._scan() == [(hash_values("b"), (b"beta",), -1)]
    assert provider.fetches == []


# ----------------------------------------------------------------- S3 family
def _s3_read(pw, client, path="s3://mybucket/data/", schema=None, **kw):
    return pw.io.s3.read(path, aws_s3_settings=pw.io.s3.AwsS3Settings(client=client),
                         format="json", schema=schema or _word(pw), **kw)


def test_s3_static_read_parses_objects():
    objects = {"data/a.jsonl": _jsonl("cat", "dog"), "data/b.jsonl": _jsonl("cat"),
               "other/c.jsonl": _jsonl("bird")}

    def build(pw):
        t = _s3_read(pw, _StubS3Client(objects), mode="static")
        return t.groupby(t.word).reduce(t.word, c=pw.reducers.count())

    rows, _ = _both(build)
    assert sorted(rows.values()) == [("cat", 2), ("dog", 1)]


def _s3_conn(pkg, client, schema_of=_word, path="s3://b/d/", settings=None):
    from importlib import import_module

    pw = PW[pkg]
    pw.clear_graph()
    settings = settings or pw.io.s3.AwsS3Settings(client=client)
    pw.io.s3.read(path, aws_s3_settings=settings, format="json", schema=schema_of(pw),
                  mode="static")
    cls = import_module(f"{pw.__name__}.io.s3")._S3ScanConnector
    return next(c for c in pw.G.connectors if isinstance(c, cls))


def _s3_script(script, schema_of=_word):
    """``script(conn, client)`` -> its scans' deltas, in each package;
    equal, keys included."""
    out = {}
    for pkg in PACKAGES:
        client = _StubS3Client({})
        out[pkg] = script(lambda: _s3_conn(pkg, client, schema_of), client)
    assert out["torch"] == out["jax"]
    return out["torch"]


def _signed(deltas):
    return sorted((row, d) for _k, row, d in deltas)


def test_s3_etag_change_retracts_previous_rows():
    def script(conn_of, client):
        client.objects["d/a.jsonl"] = _jsonl("old1", "old2")
        conn = conn_of()
        first = conn._read_new()
        client.objects["d/a.jsonl"] = _jsonl("old1", "new3")
        return first, conn._read_new()

    first, second = _s3_script(script)
    assert _signed(first) == [(("old1",), 1), (("old2",), 1)]
    assert _signed(second) == [(("new3",), 1), (("old2",), -1)]


def test_s3_pk_upsert_and_owner_deletion():
    def script(conn_of, client):
        client.objects["d/a.jsonl"] = _pk_jsonl(("k", 1), ("m", 5))
        conn = conn_of()
        out = [conn._read_new()]
        client.objects["d/a.jsonl"] = _pk_jsonl(("k", 2), ("m", 5))
        out.append(conn._read_new())
        del client.objects["d/a.jsonl"]
        out += [conn._read_new(), conn._read_new()]
        return out

    first, upd, gone, quiet = _s3_script(script, _pk_word)
    assert len(first) == 2 and quiet == []
    assert _signed(upd) == [(("k", 1), -1), (("k", 2), 1)]
    assert _signed(gone) == [(("k", 2), -1), (("m", 5), -1)]


def test_s3_pk_duplicate_source_and_failover():
    """A duplicate object's deletion keeps the row; an owner's deletion
    falls back to the surviving object's value (JAX's two cases)."""
    def script(conn_of, client):
        client.objects["d/a.jsonl"] = _pk_jsonl(("k", 1))
        conn = conn_of()
        out = [conn._read_new()]
        client.objects["d/b.jsonl"] = _pk_jsonl(("k", 1))
        out.append(conn._read_new())
        del client.objects["d/b.jsonl"]
        out.append(conn._read_new())
        client.objects["d/c.jsonl"] = _pk_jsonl(("k", 2))
        out.append(conn._read_new())
        del client.objects["d/c.jsonl"]
        out.append(conn._read_new())
        del client.objects["d/a.jsonl"]
        out.append(conn._read_new())
        return out

    first, dup, dup_gone, newer, owner_gone, last = _s3_script(script, _pk_word)
    assert len(first) == 1 and dup == [] and dup_gone == []
    assert _signed(newer) == [(("k", 1), -1), (("k", 2), 1)]
    assert _signed(owner_gone) == [(("k", 1), 1), (("k", 2), -1)]
    assert _signed(last) == [(("k", 1), -1)]


def test_s3_deleted_object_retracts_rows_and_offsets_seek():
    def script(conn_of, client):
        client.objects.update({"d/a.jsonl": _jsonl("keep"),
                               "d/b.jsonl": _jsonl("gone1", "gone2")})
        conn = conn_of()
        first = conn._read_new()
        off = conn.current_offset()
        del client.objects["d/b.jsonl"]
        return first, conn._read_new(), conn._read_new(), off

    first, gone, quiet, off = _s3_script(script)
    assert len(first) == 3 and quiet == []
    assert _signed(gone) == [(("gone1",), -1), (("gone2",), -1)]
    assert off == {"seen": off["seen"], "counts": {"d/a.jsonl": 1, "d/b.jsonl": 2}}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_s3_bucket_from_settings_and_seek(pkg):
    pw = PW[pkg]
    client = _StubS3Client({"pre/a.jsonl": _jsonl("q")})
    settings = pw.io.s3.AwsS3Settings(bucket_name="frombucket", client=client)
    conn = _s3_conn(pkg, client, path="pre/", settings=settings)
    assert conn.bucket == "frombucket"
    conn._read_new()
    off = conn.current_offset()
    assert list(off["seen"]) == ["pre/a.jsonl"]
    conn2 = type(conn)(conn.node, client, "frombucket", "pre/", "json", _word(pw),
                       "static", False, None)
    conn2.seek_offset(off)
    assert conn2._read_new() == []


def test_s3_streaming_new_object_and_fetch_retry():
    """A new object mid-stream is picked up; an object whose first fetch
    fails is retried on a later scan (JAX's two streaming cases in one)."""
    events = {}
    for pkg in PACKAGES:
        client = _StubS3Client({"p/a.jsonl": _jsonl("x"), "p/bad.jsonl": _jsonl("y")})
        orig, fails = client.get_object, {"p/bad.jsonl": 1}

        def flaky(Bucket, Key, orig=orig, fails=fails):
            if fails.get(Key, 0) > 0:
                fails[Key] -= 1
                raise RuntimeError("NoSuchKey")
            return orig(Bucket=Bucket, Key=Key)

        client.get_object = flaky

        def feed(wait_for, client=client):
            wait_for(1)
            client.objects["p/c.jsonl"] = _jsonl("z")

        events[pkg] = _stream(pkg, lambda pw, client=client: _s3_read(
            pw, client, "s3://b/p/", mode="streaming", refresh_interval=0.05),
            lambda ev: len(ev) >= 3, feed)
    assert sorted(events["torch"]) == sorted(events["jax"])
    assert sorted(r for _k, r, _a in events["torch"]) == [("x",), ("y",), ("z",)]


def test_s3_local_path_and_s3_csv_fall_back_to_fs(tmp_path):
    (tmp_path / "a.jsonl").write_text(json.dumps({"word": "local"}) + "\n")
    rows, _ = _both(lambda pw: pw.io.s3.read(str(tmp_path), format="json",
                                             schema=_word(pw), mode="static"))
    assert list(rows.values()) == [("local",)]
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    (csv_dir / "data.csv").write_text("a,b\n1,x\n2,y\n")
    rows, _ = _both(lambda pw: pw.io.s3_csv.read(
        str(csv_dir), schema=pw.schema_from_types(a=int, b=str), mode="static"))
    assert sorted(rows.values()) == [(1, "x"), (2, "y")]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_minio_and_vendor_settings(pkg):
    pw = PW[pkg]
    client = _StubS3Client({"m/a.jsonl": _jsonl("mini")})
    aws = pw.io.minio.MinIOSettings(endpoint="https://minio.local", bucket_name="mb",
                                    access_key="ak", secret_access_key="sk",
                                    ).create_aws_settings()
    assert aws.endpoint == "https://minio.local" and aws.with_path_style is True
    aws.client = client
    conn = _s3_conn(pkg, client, path="m/", settings=aws)
    assert conn.bucket == "mb"
    assert [r for _k, r, _d in conn._read_new()] == [("mini",)]
    do = pw.io.s3.DigitalOceanS3Settings("b", region="ams3")._to_aws()
    wa = pw.io.s3.WasabiS3Settings("b", region="eu-central-1")._to_aws()
    assert do.endpoint == "https://ams3.digitaloceanspaces.com"
    assert wa.endpoint == "https://s3.eu-central-1.wasabisys.com"


# --------------------------------------------------------------------- sinks
def test_postgres_write_and_write_snapshot(tmp_path):
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        db = tmp_path / f"pg-{pkg}.db"
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE out (word TEXT, n INTEGER, time INTEGER, diff INTEGER)")
        conn.execute("CREATE TABLE snap (k TEXT, v INTEGER)")
        conn.commit()
        conn.close()
        factory = lambda db=db: sqlite3.connect(db)  # noqa: E731
        pw.io.postgres.write(_md(pw, """
            word | n
            cat  | 1
            dog  | 2
            """), table_name="out", connection_factory=factory)
        pw.io.postgres.write_snapshot(_md(pw, """
            k | v | __time__ | __diff__
            a | 1 | 2        | 1
            b | 3 | 2        | 1
            a | 1 | 4        | -1
            a | 9 | 4        | 1
            b | 3 | 6        | -1
            """), table_name="snap", primary_key=["k"], connection_factory=factory)
        pw.run()
        db_conn = sqlite3.connect(db)
        out[pkg] = (db_conn.execute("SELECT word, n, diff FROM out ORDER BY word").fetchall(),
                    db_conn.execute("SELECT k, v FROM snap").fetchall())
    assert out["torch"] == out["jax"]
    assert out["torch"] == ([("cat", 1, 1), ("dog", 2, 1)], [("a", 9)])


def _sink_case(name, pw, t, got):
    if name == "mongodb":
        class Coll:
            def insert_many(self, docs):
                got.extend(docs)

        client = {"d": {"c": Coll()}}
        pw.io.mongodb.write(t, connection_string="stub://", database="d", collection="c",
                            _client=client)
    elif name == "elasticsearch":
        class Es:
            def index(self, index, document, **kw):
                got.append((index, document))

        pw.io.elasticsearch.write(t, host="stub", index_name="idx", _client=Es())
    elif name == "nats":
        class Nats:
            def publish(self, subject, payload):
                got.append((subject, json.loads(payload)))

        pw.io.nats.write(t, uri="stub://", topic="subj", _client=Nats())
    elif name == "bigquery":
        class Bq:
            def insert_rows_json(self, table_ref, rows):
                got.append((table_ref, rows))
                return []

        pw.io.bigquery.write(t, "animals", "measurements", _client=Bq())
    elif name == "pubsub":
        class Pub:
            def topic_path(self, project, topic):
                return f"projects/{project}/topics/{topic}"

            def publish(self, path, data, **attrs):
                got.append((path, data, attrs["pathway_diff"]))

        pw.io.pubsub.write(t.select(data=t.word), Pub(), "proj", "blobs")
    elif name == "logstash":
        pw.io.logstash.write(t, "http://logstash.invalid:8080",
                             _sender=lambda u, b: got.append((u, json.loads(b)["word"])))
    elif name == "slack":
        pw.io.slack.send_alerts(t.word, "C000", "xoxb-token", _sender=got.append)


@pytest.mark.parametrize("name", ["mongodb", "elasticsearch", "nats", "bigquery", "pubsub",
                                  "logstash", "slack"])
def test_thin_sinks_receive_the_same(name):
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        got = []
        _sink_case(name, pw, _md(pw, """
            word | n
            cat  | 1
            dog  | 2
            """), got)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)

        def scrub(v):  # the commit time is a wall-clock time
            if isinstance(v, dict):
                return {k: scrub(x) for k, x in v.items() if k != "time"}
            if isinstance(v, (list, tuple)):
                return type(v)(scrub(x) for x in v)
            return v

        out[pkg] = sorted(map(repr, scrub(got)))
    assert out["torch"] == out["jax"] and len(out["torch"]) >= 1


def test_redpanda_is_the_kafka_alias():
    import pathway_tpu_torch as TPW

    assert TPW.io.redpanda.read is TPW.io.kafka.read
    assert TPW.io.redpanda.write is TPW.io.kafka.write
    assert TPW.io.redpanda.InMemoryKafkaBroker is TPW.io.kafka.InMemoryKafkaBroker


@pytest.mark.parametrize("pkg", PACKAGES)
def test_nats_read_live_subscription(pkg, monkeypatch):
    """A stubbed ``nats`` module: published messages stream in, a
    malformed one is skipped and logged (JAX's case)."""
    pw = PW[pkg]
    holder = []

    class Msg:
        def __init__(self, data):
            self.data = data

    class NC:
        def __init__(self):
            self.cb = None

        async def subscribe(self, subject, cb=None, queue=None):
            self.cb = cb

        async def close(self):
            pass

    async def connect(uri):
        holder.append(NC())
        return holder[-1]

    mod = types.ModuleType("nats")
    mod.connect = connect
    monkeypatch.setitem(sys.modules, "nats", mod)

    def feed(wait_for):
        deadline = time.time() + WAIT
        _wait(lambda: holder and holder[0].cb is not None, deadline)
        for data in (json.dumps({"word": "n1"}).encode(), b"garbage{{",
                     json.dumps({"word": "n2"}).encode()):
            asyncio.run(holder[0].cb(Msg(data)))

    events = _stream(pkg, lambda pw: pw.io.nats.read("nats://stub:4222", "subj",
                                                     schema=_word(pw)),
                     lambda ev: len(ev) >= 2, feed)
    assert sorted(r for _k, r, _a in events) == [("n1",), ("n2",)]
    log = pw.internals.errors.get_global_error_log()
    assert any("nats" in e["message"] for e in log.entries)


@pytest.mark.parametrize("case", ["mongodb", "elasticsearch", "bigquery", "gdrive", "nats",
                                  "nats_write", "deltalake", "deltalake_write", "postgres",
                                  "s3"])
def test_missing_client_package_raises_the_same(case, monkeypatch):
    """No fallback hides an absent SDK: each package raises ImportError
    with the same message."""
    gate = {"mongodb": ["pymongo"], "elasticsearch": ["elasticsearch"],
            "bigquery": ["google.cloud.bigquery", "google.cloud"],
            "gdrive": ["googleapiclient", "googleapiclient.discovery",
                       "google.oauth2.service_account"],
            "nats": ["nats"], "nats_write": ["nats"], "deltalake": ["deltalake"],
            "deltalake_write": ["deltalake"], "postgres": ["psycopg", "psycopg2"],
            "s3": ["boto3"]}[case]
    for m in gate:
        monkeypatch.setitem(sys.modules, m, None)
    msgs = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = _md(pw, """
            word
            cat
            """)
        call = {
            "mongodb": lambda: pw.io.mongodb.write(t, "stub://", "d", "c"),
            "elasticsearch": lambda: pw.io.elasticsearch.write(t, "stub", index_name="i"),
            "bigquery": lambda: pw.io.bigquery.write(t, "d", "t"),
            "gdrive": lambda: pw.io.gdrive.read("folder", mode="static"),
            "nats": lambda: pw.io.nats.read("nats://x", "s", schema=_word(pw)),
            "nats_write": lambda: pw.io.nats.write(t, "nats://x", "s"),
            "deltalake": lambda: pw.io.deltalake.read("mem://dl", _word(pw)),
            "deltalake_write": lambda: pw.io.deltalake.write(t, "mem://dl"),
            "postgres": lambda: pw.io.postgres.write(t, {"host": "x"}, "out") or pw.run(),
            "s3": lambda: pw.io.s3.read("s3://b/p/", format="json", schema=_word(pw)),
        }[case]
        with pytest.raises(ImportError) as err:
            call()
        msgs[pkg] = str(err.value)
    assert msgs["torch"] == msgs["jax"]
