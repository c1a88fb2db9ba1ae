"""The port's Airbyte reader (``pathway_tpu_torch/io/airbyte.py``) against
JAX's (``pathway_tpu/io/airbyte.py``): JAX's cases of
``tests/test_io_backends.py`` (the fake source, an executable connector
written into ``tmp_path`` that speaks spec / discover / read, the docker
envelope, the Cloud Run source with injected jobs and logs doubles, alone
and through the engine) run through both packages, which must give the
same rows under the same keys; and ``airbyte create-source`` writes JAX's
scaffold byte for byte. Nothing is downloaded and no docker runs."""

import sys

import pytest

import pathway_tpu as JPW
import pathway_tpu.io.airbyte as JA
import pathway_tpu_torch as TPW
import pathway_tpu_torch.io.airbyte as TA
from tests.torch_engine import PACKAGES, PW, final_state

AIRBYTE = {"jax": JA, "torch": TA}


@pytest.fixture(autouse=True)
def _clear_graphs():
    JPW.clear_graph()
    TPW.clear_graph()
    yield
    JPW.clear_graph()
    TPW.clear_graph()


class FakeAirbyteSource:
    def extract(self, streams):
        return [
            {"record": {"stream": "users", "data": {"id": 1, "name": "ann"}}},
            {"record": {"stream": "users", "data": {"id": 2, "name": "bob"}}},
            {"record": {"stream": "other", "data": {"id": 3}}},
            {"state": {}},
        ]


def _read(pkg, source, **kw):
    PW[pkg].clear_graph()
    t = PW[pkg].io.airbyte.read(streams=["users"], mode="static", _source=source, **kw)
    return final_state(pkg, t)


def test_airbyte_read_records_same_rows_and_keys():
    jrows, jcols = _read("jax", FakeAirbyteSource())
    trows, tcols = _read("torch", FakeAirbyteSource())
    assert tcols == jcols == ["data"]
    assert trows == jrows and len(trows) == 2
    assert sorted(r[0] for r in trows.values()) == [
        "pw.Json({'id': 1, 'name': 'ann'})", "pw.Json({'id': 2, 'name': 'bob'})"]


FAKE_CONNECTOR = r'''
import argparse
import json
import sys

p = argparse.ArgumentParser()
p.add_argument("action")
p.add_argument("--config")
p.add_argument("--catalog")
p.add_argument("--state")
a = p.parse_args()

def emit(m):
    sys.stdout.write(json.dumps(m) + "\n")

if a.action == "spec":
    emit({"type": "SPEC", "spec": {"connectionSpecification": {}}})
elif a.action == "discover":
    assert a.config
    emit({"type": "CATALOG", "catalog": {"streams": [
        {"name": "users", "supported_sync_modes": ["full_refresh", "incremental"],
         "default_cursor_field": ["id"]},
        {"name": "other", "supported_sync_modes": ["full_refresh"]},
    ]}})
elif a.action == "read":
    assert a.config and a.catalog
    cat = json.load(open(a.catalog))
    assert {s["stream"]["name"] for s in cat["streams"]} == {"users"}
    assert cat["streams"][0]["sync_mode"] == "incremental"
    start = 0
    if a.state:
        start = json.load(open(a.state)).get("cursor", 0)
    emit({"type": "LOG", "log": {"message": "starting"}})
    print("not json noise")
    print('"a bare string"')
    for i in range(start, start + 2):
        emit({"type": "RECORD",
              "record": {"stream": "users", "data": {"id": i}}})
    emit({"type": "STATE", "state": {"cursor": start + 2}})
'''


@pytest.fixture
def connector(tmp_path):
    script = tmp_path / "fake_connector.py"
    script.write_text(FAKE_CONNECTOR)
    return f"{sys.executable} {script}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_airbyte_executable_source_protocol(connector, pkg):
    """spec / discover / read with --config / --catalog / --state file
    arguments, JSON-lines parsing (noise skipped), and the incremental
    STATE carried between polls."""
    src = AIRBYTE[pkg].ExecutableAirbyteSource(connector, config={"token": "x"},
                                               streams=["users"])
    assert src.spec == {"connectionSpecification": {}}
    assert [s["stream"]["name"] for s in src.configured_catalog["streams"]] == ["users"]
    first = src.extract()
    assert [m["record"]["data"]["id"] for m in first] == [0, 1]
    assert src.state == {"cursor": 2}
    second = src.extract()  # resumes FROM the carried state
    assert [m["record"]["data"]["id"] for m in second] == [2, 3]
    assert src.state == {"cursor": 4}


def test_airbyte_executable_source_through_connector(connector):
    got = {}
    for pkg in PACKAGES:
        src = AIRBYTE[pkg].ExecutableAirbyteSource(connector, config={}, streams=["users"])
        got[pkg] = _read(pkg, src)
    assert got["torch"] == got["jax"]
    assert sorted(r[0] for r in got["torch"][0].values()) == [
        "pw.Json({'id': 0})", "pw.Json({'id': 1})"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_airbyte_executable_source_errors(tmp_path, pkg):
    """A TRACE error message raises, as does a connector that exits with a
    failure; neither leaves the process running."""
    script = tmp_path / "failing.py"
    script.write_text(
        "import json, sys\n"
        "if sys.argv[1] == 'read':\n"
        "    print(json.dumps({'type': 'TRACE', 'trace': {'error': {'message': 'bad'}}}))\n"
        "    sys.exit(0)\n"
        "sys.exit(3)\n")
    src = AIRBYTE[pkg].ExecutableAirbyteSource(f"{sys.executable} {script}")
    src._catalog = {"streams": []}
    with pytest.raises(AIRBYTE[pkg].AirbyteSourceError, match="bad"):
        src.extract()
    with pytest.raises(AIRBYTE[pkg].AirbyteSourceError, match="status 3"):
        src.spec  # noqa: B018


def test_airbyte_executable_source_env_vars(tmp_path):
    """``env_vars`` augment the caller's environment (the connector still
    finds PATH)."""
    script = tmp_path / "env_connector.py"
    script.write_text(
        "import json, os, sys\n"
        "print(json.dumps({'type': 'SPEC', 'spec': {'token': os.environ['A_TOKEN'],"
        " 'path': bool(os.environ.get('PATH'))}}))\n")
    for pkg in PACKAGES:
        src = AIRBYTE[pkg].ExecutableAirbyteSource(f"{sys.executable} {script}",
                                                   env_vars={"A_TOKEN": "se cret"})
        assert src.spec == {"token": "se cret", "path": True}


def test_airbyte_docker_envelope():
    import shutil

    args = ("airbyte/source-faker:0.1.4", "/tmp/x", "/mnt/temp", {"A_TOKEN": "se cret"})
    assert TA._docker_command(*args) == JA._docker_command(*args) == (
        "docker run --rm -i --volume /tmp/x:/mnt/temp "
        "-e A_TOKEN='se cret' airbyte/source-faker:0.1.4")
    assert TA._docker_command("img", "/a", "/b") == JA._docker_command("img", "/a", "/b")
    if shutil.which("docker") is None:
        for mod in (JA, TA):
            with pytest.raises(RuntimeError, match="docker binary"):
                mod.DockerAirbyteSource("airbyte/source-faker:0.1.4")


class _Op:
    def __init__(self, execution="exec-1"):
        class _Meta:
            name = f"projects/p/executions/{execution}"

        self.metadata = _Meta()

    def result(self):
        class _R:
            succeeded_count = 1

        return _R()


class FakeJobs:
    def __init__(self):
        self.calls = {"created": [], "run": [], "deleted": []}

    def create_job(self, job, job_id, parent):
        self.calls["created"].append((job, job_id, parent))
        return _Op()

    def run_job(self, request):
        self.calls["run"].append(request)
        return _Op(f"exec-{len(self.calls['run'])}")

    def delete_job(self, name):
        self.calls["deleted"].append(name)
        raise RuntimeError("NotFound")  # absent on first delete: ignored


CATALOG = {"streams": [{"name": "users", "supported_sync_modes": ["incremental"]}]}
MSGS = [
    {"type": "RECORD", "record": {"stream": "users", "data": {"uid": 1}}},
    {"type": "STATE", "state": {"cursor": 41}},
    {"type": "RECORD", "record": {"stream": "users", "data": {"uid": 2}}},
]


def _remote(pkg, entries, jobs):
    return AIRBYTE[pkg].RemoteAirbyteSource(
        {"source": {"docker_image": "airbyte/source-faker", "config": {"seed": 1}}},
        ["users"], job_id="pw-job", region="europe-west1", project="p",
        jobs_client=jobs, logs_lister=lambda execution_id: list(entries))


def test_airbyte_remote_cloud_run_source():
    """Job created at construction, one execution per extract with the
    state and cached-catalog overrides, results reassembled from the
    chunked log transport, job deleted on stop: the same calls, the same
    records in both packages."""
    entries = JA.LogChunkTransport.serialize(MSGS, CATALOG)
    assert TA.LogChunkTransport.serialize(MSGS, CATALOG) == entries
    assert TA._REMOTE_RUNNER_SOURCE == JA._REMOTE_RUNNER_SOURCE
    seen = {}
    for pkg in PACKAGES:
        jobs = FakeJobs()
        src = _remote(pkg, entries, jobs)
        assert len(jobs.calls["created"]) == 1 and jobs.calls["deleted"]
        job, job_id, parent = jobs.calls["created"][0]
        container = job["template"]["template"]["containers"][0]
        assert container["image"] == "airbyte/source-faker"
        assert {"PW_CONFIG", "RUNNER_CODE"} <= {e["name"] for e in container["env"]}
        records = list(src.extract(["users"]))
        assert [r["record"]["data"]["uid"] for r in records] == [1, 2]
        assert src.state == {"cursor": 41}
        list(src.extract(["users"]))
        overrides = jobs.calls["run"][1]["overrides"]["container_overrides"][0]["env"]
        assert {"AIRBYTE_STATE", "CACHED_CATALOG"} <= {e["name"] for e in overrides}
        src.on_stop()
        assert jobs.calls["deleted"][-1].endswith("/jobs/pw-job")
        seen[pkg] = jobs.calls
    assert seen["torch"] == seen["jax"]


def test_airbyte_log_transport_round_trips_across_packages():
    big = [{"type": "RECORD", "record": {"data": {"blob": "x" * 200_000}}}]
    for writer, reader in ((JA, TA), (TA, JA), (TA, TA)):
        entries = writer.LogChunkTransport.serialize(big, CATALOG)
        assert len(entries) > 2  # metadata + several chunks
        t = reader.LogChunkTransport()
        for e in reversed(entries):  # arrival order must not matter
            t.append(e)
        t.append(entries[1])  # a duplicated chunk entry (at-least-once)
        assert t.messages() == big


@pytest.mark.parametrize("pkg", PACKAGES)
def test_airbyte_remote_refusals(pkg):
    mod = AIRBYTE[pkg]
    with pytest.raises(ValueError, match="project"):
        mod.RemoteAirbyteSource({"source": {"docker_image": "i"}}, ["users"], job_id="j",
                                region="r", jobs_client=FakeJobs(),
                                logs_lister=lambda eid: [])
    err = [{"type": "TRACE", "trace": {"error": {"message": "remote broke"}}}]
    src = _remote(pkg, mod.LogChunkTransport.serialize(err, CATALOG), FakeJobs())
    with pytest.raises(mod.AirbyteSourceError, match="remote broke"):
        src.extract(["users"])
    assert src.state is None
    with pytest.raises(ValueError, match="execution_type"):
        PW[pkg].io.airbyte.read("c.yaml", ["users"], execution_type="cloud")


def test_airbyte_remote_through_engine():
    msgs = [{"type": "RECORD", "record": {"stream": "users", "data": {"uid": i}}}
            for i in range(4)]
    entries = JA.LogChunkTransport.serialize(
        msgs, {"streams": [{"name": "users", "supported_sync_modes": []}]})

    class Jobs:
        def create_job(self, **kw):
            return _Op()

        def run_job(self, request):
            return _Op("exec-9")

        def delete_job(self, name):
            return _Op()

    got = {}
    for pkg in PACKAGES:
        src = AIRBYTE[pkg].RemoteAirbyteSource(
            {"source": {"docker_image": "img", "config": {}}}, ["users"], job_id="j",
            region="r", project="p", jobs_client=Jobs(), logs_lister=lambda eid: list(entries))
        got[pkg] = _read(pkg, src)
    assert got["torch"] == got["jax"] and len(got["torch"][0]) == 4


def test_airbyte_read_registers_its_persistent_id(monkeypatch):
    import pathway_tpu.persistence as JP
    import pathway_tpu_torch.persistence as TP

    seen = []
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "register_persistent_source",
                            lambda pid, conn, _m=mod: seen.append((_m.__name__, pid,
                                                                   type(conn).__name__)))
    for pkg in PACKAGES:
        PW[pkg].io.airbyte.read(streams=["users"], mode="static",
                                _source=FakeAirbyteSource(), persistent_id="users-src")
    assert [s[1:] for s in seen] == [("users-src", "_AirbyteConnector")] * 2


def test_airbyte_create_source_writes_jax_scaffold(tmp_path, capsys):
    from click.testing import CliRunner

    from pathway_tpu.cli import cli as jax_cli
    from pathway_tpu_torch import cli as tcli

    for image in (None, "airbyte/source-github:1.0"):
        extra = [] if image is None else ["--image", image]
        jpath, tpath = tmp_path / "jax" / "conn.yaml", tmp_path / "torch" / "sub" / "conn.yaml"
        res = CliRunner().invoke(jax_cli, ["airbyte", "create-source", str(jpath), *extra])
        assert res.exit_code == 0, res.output
        assert tcli.main(["airbyte", "create-source", str(tpath), *extra]) == 0
        assert tpath.read_bytes() == jpath.read_bytes()
        assert capsys.readouterr().out == res.output
