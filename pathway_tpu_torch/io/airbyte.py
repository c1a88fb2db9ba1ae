"""Airbyte source connector (counterpart of ``pathway_tpu/io/airbyte.py``;
reference ``python/pathway/io/airbyte``:
runs an Airbyte connector and streams its RECORD messages as a
``data: Json`` column, incremental STATE kept between polls).

Execution modes (reference ``io/airbyte/logic.py`` +
``third_party/airbyte_serverless/sources.py:89-140``):

* ``execution_type="local"`` — a local connector process. Either the
  ``airbyte_serverless`` package (PyPI venv runner) or any executable
  speaking the Airbyte protocol via :class:`ExecutableAirbyteSource`.
* ``execution_type="docker"`` — the connector's public Docker image,
  wrapped as ``docker run --rm -i --volume <tmp>:<mnt> <image>``
  (:class:`DockerAirbyteSource`). Gated on a ``docker`` binary.
* ``execution_type="remote"`` — the connector image runs as a Google
  Cloud Run JOB (:class:`RemoteAirbyteSource`): a self-contained runner
  script is delivered via env var, incremental state rides the execution
  overrides, and results come back through Cloud Logging in the
  reference-compatible chunked transport. Gated on the google-cloud
  SDKs; tests inject jobs/logs client doubles.
* ``_source=...`` — any object with ``extract(streams) -> iterable`` of
  Airbyte RECORD message dicts (in-process; used by tests and embedded
  sources).

The subprocess contract is the standard Airbyte connector CLI: actions
``spec`` / ``discover --config c.json`` / ``read --config c.json
--catalog cat.json [--state s.json]``, each emitting JSON-lines messages
on stdout; RECORD rows stream into the table, the latest STATE message is
fed back on the next poll so incremental streams resume instead of
re-reading.

``yaml`` and ``google.oauth2`` are imported inside the functions that need
them, as in JAX. A connector process gets the caller's environment plus
``env_vars`` (JAX's ``environ_snapshot``; the port keeps its own helper).
"""

from __future__ import annotations

import json as json_mod
import os
import shlex
import subprocess
import tempfile
import time as time_mod
from typing import Any, Iterable, Sequence

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import config
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector


def environ_snapshot(**env_vars: str) -> dict[str, str]:
    """The environment a connector process inherits from its caller, plus
    ``env_vars``: the caller's variables are the connector's (``PATH`` and
    the like), not a setting the library reads."""
    return config.environ_snapshot(**env_vars)


class AirbyteSourceError(RuntimeError):
    """A connector emitted a TRACE error message (reference
    ``executable_runner.py: AirbyteSourceException``)."""


class ExecutableAirbyteSource:
    """Runs any executable speaking the Airbyte connector CLI protocol.

    ``executable`` is the command prefix (string, shell-quoted as needed);
    config/catalog/state are passed as ``--name <tempdir>/name.json`` file
    arguments exactly like the reference's runner
    (``third_party/airbyte_serverless/executable_runner.py:208-246``).
    Incremental: the newest STATE message from each ``read`` is kept on
    ``self.state`` and passed back on the next ``extract``."""

    def __init__(self, executable: str, config: dict | None = None,
                 streams: Sequence[str] | None = None,
                 env_vars: dict[str, str] | None = None):
        self.executable = executable
        self.config = config or {}
        self.streams = list(streams or [])
        self.env_vars = env_vars
        self._temp_dir_obj = tempfile.TemporaryDirectory()
        self.temp_dir = self._temp_dir_obj.name
        # where the executable sees the temp dir (differs under docker,
        # where the host dir is volume-mounted)
        self.temp_dir_for_executable = self.temp_dir
        self.state: Any = None
        self._catalog: dict | None = None

    # -- protocol ----------------------------------------------------------
    def _run(self, action: str, state=None) -> Iterable[dict]:
        command = f"{self.executable} {action}"

        def add_argument(name: str, value) -> str:
            path = os.path.join(self.temp_dir, f"{name}.json")
            with open(path, "w", encoding="utf-8") as f:
                json_mod.dump(value, f)
            return (
                f" --{name} {self.temp_dir_for_executable}/{name}.json"
            )

        if action != "spec":
            command += add_argument("config", self.config)
        if action == "read":
            command += add_argument("catalog", self.configured_catalog)
            if state is not None:
                command += add_argument("state", state)
        env = (
            environ_snapshot(**self.env_vars) if self.env_vars else None
        )  # augment, never replace: the connector still needs PATH etc.
        proc = subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            shell=True, env=env,
        )
        assert proc.stdout is not None
        try:
            for line in iter(proc.stdout.readline, b""):
                content = line.decode(errors="replace").strip()
                if not content:
                    continue
                try:
                    message = json_mod.loads(content)
                except ValueError:
                    continue  # connectors log non-JSON noise on stdout
                if not isinstance(message, dict):
                    continue  # valid-JSON scalar noise (e.g. bare strings)
                if (message.get("trace") or {}).get("error"):
                    raise AirbyteSourceError(
                        json_mod.dumps(message["trace"]["error"])
                    )
                yield message
            proc.wait()
            if proc.returncode != 0:
                raise AirbyteSourceError(
                    f"connector exited with status {proc.returncode} "
                    f"(action {action!r})"
                )
        finally:
            # early generator close (_first_message, TRACE error) must not
            # leak a running connector process
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def _first_message(self, action: str) -> dict:
        for message in self._run(action):
            if message.get("type") not in ("LOG", "TRACE"):
                return message
        raise AirbyteSourceError(f"no message from action {action!r}")

    @property
    def spec(self) -> dict:
        return self._first_message("spec")["spec"]

    @property
    def catalog(self) -> dict:
        if self._catalog is None:
            self._catalog = self._first_message("discover")["catalog"]
        return self._catalog

    @property
    def configured_catalog(self) -> dict:
        """Every requested stream, incremental where the connector supports
        it (reference ``executable_runner.py: get_configured_catalog``)."""
        configured = []
        for stream in self.catalog.get("streams", []):
            if self.streams and stream.get("name") not in self.streams:
                continue
            modes = stream.get("supported_sync_modes") or ["full_refresh"]
            sync_mode = (
                "incremental" if "incremental" in modes else "full_refresh"
            )
            configured.append(
                {
                    "stream": stream,
                    "sync_mode": sync_mode,
                    "destination_sync_mode": "append",
                    "cursor_field": stream.get("default_cursor_field", []),
                }
            )
        return {"streams": configured}

    def extract(self, streams: Sequence[str] | None = None) -> list[dict]:
        """One ``read`` pass: returns RECORD messages, stores the newest
        STATE for the next call."""
        if streams:
            self.streams = list(streams)
        out = []
        for message in self._run("read", state=self.state):
            mtype = message.get("type")
            if mtype == "RECORD":
                out.append(message)
            elif mtype == "STATE":
                self.state = message.get("state")
        return out


def _docker_command(image: str, temp_dir: str, mount_dir: str,
                    env_vars: dict[str, str] | None = None) -> str:
    """The docker envelope the reference builds
    (``third_party/airbyte_serverless/sources.py:108-111``)."""
    env = " ".join(
        f"-e {shlex.quote(k)}={shlex.quote(v)}"
        for k, v in (env_vars or {}).items()
    )
    env = f"{env} " if env else ""
    return (
        f"docker run --rm -i --volume {temp_dir}:{mount_dir} "
        f"{env}{image}"
    )


class DockerAirbyteSource(ExecutableAirbyteSource):
    """Runs the connector's public Docker image. Gated: constructing
    without a ``docker`` binary raises (this build's image has none; the
    envelope itself is covered by tests through ``_docker_command``)."""

    def __init__(self, connector: str, config: dict | None = None,
                 streams: Sequence[str] | None = None,
                 env_vars: dict[str, str] | None = None):
        import shutil

        if shutil.which("docker") is None:
            raise RuntimeError(
                "execution_type='docker' needs a docker binary on PATH; "
                "use execution_type='local' or pass _source=..."
            )
        super().__init__("", config, streams)
        self.docker_image = connector
        self.temp_dir_for_executable = "/mnt/temp"
        self.executable = _docker_command(
            connector, self.temp_dir, self.temp_dir_for_executable, env_vars
        )


# ---------------------------------------------------------------------------
# remote (Google Cloud Run) execution


class LogChunkTransport:
    """The chunked stdout->Cloud-Logging result transport the reference's
    remote runner speaks (``executable_runner.py:52-160``): the run's
    messages + zlib/b64 catalog are JSON-serialized, split into
    log-entry-sized chunks, and printed with an index header so the
    collector can reassemble them from unordered log entries. Field names
    match the reference wire format, so either side's runner works with
    either side's collector."""

    ENTRY_TYPE = "__entry_type"
    INDEX = "index"
    PAYLOAD = "payload"
    MESSAGES = "messages"
    CATALOG = "catalog"
    METADATA = "metadata"
    CHUNK = "chunk"
    N_CHUNKS = "n_chunks"
    MAX_LOG_ENTRY_LENGTH = 262144
    MAX_ENV_LENGTH = 32768

    @classmethod
    def serialize(cls, messages: list, catalog: Any) -> list[dict]:
        import base64
        import zlib

        catalog_b64 = base64.b64encode(
            zlib.compress(
                json_mod.dumps(catalog, ensure_ascii=False).encode(),
                level=zlib.Z_BEST_COMPRESSION,
            )
        ).decode()
        if len(catalog_b64) > cls.MAX_ENV_LENGTH:
            catalog_b64 = None
        body = json_mod.dumps(
            {cls.MESSAGES: list(messages), cls.CATALOG: catalog_b64},
            ensure_ascii=False,
        )
        size = int(cls.MAX_LOG_ENTRY_LENGTH * 0.9 / 4 - 256) // 2
        chunks = [body[i : i + size] for i in range(0, len(body), size)]
        out = [{cls.ENTRY_TYPE: cls.METADATA, cls.N_CHUNKS: len(chunks)}]
        out.extend(
            {cls.ENTRY_TYPE: cls.CHUNK, cls.INDEX: i, cls.PAYLOAD: c}
            for i, c in enumerate(chunks)
        )
        return out

    def __init__(self):
        self._expected: int | None = None
        # keyed by index: Cloud Logging delivers at-least-once, and a
        # duplicated chunk entry must not wedge the count-based check
        self._chunks: dict[int, str] = {}

    def append(self, payload: Any) -> None:
        if not isinstance(payload, dict):
            return
        entry = payload.get(self.ENTRY_TYPE)
        if entry == self.METADATA:
            self._expected = payload[self.N_CHUNKS]
        elif entry == self.CHUNK:
            self._chunks[int(payload[self.INDEX])] = payload[self.PAYLOAD]

    def _restore(self):
        if self._expected is None or self._expected != len(self._chunks):
            return None
        return json_mod.loads(
            "".join(self._chunks[i] for i in sorted(self._chunks))
        )

    def messages(self):
        r = self._restore()
        return None if r is None else r[self.MESSAGES]

    def catalog_b64(self):
        r = self._restore()
        return None if r is None else r[self.CATALOG]


# The script delivered (base64, env var) into the connector container on
# Cloud Run: runs discover + read against the image's own entrypoint and
# prints the results through the chunked log transport. Self-contained —
# the container only needs python3 (every Airbyte connector image has it).
_REMOTE_RUNNER_TEMPLATE = r'''
import base64, json, os, shlex, subprocess, tempfile, zlib

MAX_LOG = @MAX_LOG@
MAX_ENV = @MAX_ENV@

def sh(cmd):
    out = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    lines = []
    for line in out.stdout.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            lines.append(json.loads(line))
        except ValueError:
            continue
    return lines, out.returncode, out.stderr[-2000:]

cfg = json.loads(zlib.decompress(base64.b64decode(os.environ["PW_CONFIG"])))
entry = os.environ.get("AIRBYTE_ENTRYPOINT", "python /airbyte/integration_code/main.py")
tmp = tempfile.mkdtemp()
cpath = os.path.join(tmp, "config.json")
with open(cpath, "w") as f:
    json.dump(cfg.get("config", {}), f)
catalog = None
cached = os.environ.get("CACHED_CATALOG")
if cached:
    catalog = json.loads(zlib.decompress(base64.b64decode(cached)))
if catalog is None:
    found, rc, err = sh(f"{entry} discover --config {shlex.quote(cpath)}")
    for m in found:
        if m.get("type") == "CATALOG":
            catalog = m["catalog"]
    if catalog is None:
        raise SystemExit(f"no CATALOG from discover (rc={rc}): {err}")
streams = [s for s in (cfg.get("streams") or []) if s]
conf = {
    "streams": [
        {
            "stream": st,
            "sync_mode": (
                "incremental"
                if "incremental" in (st.get("supported_sync_modes") or [])
                else "full_refresh"
            ),
            "destination_sync_mode": "append",
            "cursor_field": st.get("default_cursor_field", []),
        }
        for st in catalog["streams"]
        if not streams or st["name"] in streams
    ]
}
catpath = os.path.join(tmp, "catalog.json")
with open(catpath, "w") as f:
    json.dump(conf, f)
cmd = f"{entry} read --config {shlex.quote(cpath)} --catalog {shlex.quote(catpath)}"
state = os.environ.get("AIRBYTE_STATE")
if state and state != "null":
    spath = os.path.join(tmp, "state.json")
    with open(spath, "w") as f:
        f.write(state)
    cmd += f" --state {shlex.quote(spath)}"
raw, rc, err = sh(cmd)
messages = [
    m for m in raw if m.get("type") in ("RECORD", "STATE", "TRACE")
]
if rc != 0 and not messages:
    # a silently-crashed read must surface as an ERROR, not an empty poll
    messages = [{
        "type": "TRACE",
        "trace": {"error": {"message": f"connector read failed rc={rc}",
                            "stderr": err}},
    }]
catalog_b64 = base64.b64encode(
    zlib.compress(json.dumps(catalog, ensure_ascii=False).encode(), 9)
).decode()
if len(catalog_b64) > MAX_ENV:
    catalog_b64 = None
body = json.dumps({"messages": messages, "catalog": catalog_b64},
                  ensure_ascii=False)
size = int(MAX_LOG * 0.9 / 4 - 256) // 2
chunks = [body[i:i + size] for i in range(0, len(body), size)]
print(json.dumps({"__entry_type": "metadata", "n_chunks": len(chunks)}))
for i, c in enumerate(chunks):
    print(json.dumps({"__entry_type": "chunk", "index": i, "payload": c},
                     ensure_ascii=False))
'''

# one source of truth for the wire constants: the embedded runner is the
# template with the transport's limits substituted in
_REMOTE_RUNNER_SOURCE = (
    _REMOTE_RUNNER_TEMPLATE
    .replace("@MAX_LOG@", str(LogChunkTransport.MAX_LOG_ENTRY_LENGTH))
    .replace("@MAX_ENV@", str(LogChunkTransport.MAX_ENV_LENGTH))
)


class RemoteAirbyteSource:
    """Runs the connector image as a Google Cloud Run JOB (reference
    ``RemoteAirbyteSource``, ``third_party/airbyte_serverless/
    sources.py:173``): the job is created at construction, each
    ``extract`` triggers one execution with the incremental state (and
    cached catalog) delivered via env overrides, and results come back
    through Cloud Logging using the chunked transport above.

    Gated: without the ``google-cloud-run`` / ``google-cloud-logging``
    SDKs, construction requires injected ``jobs_client`` (create_job /
    run_job / delete_job) and ``logs_lister(execution_id) ->
    iterable[payload]`` doubles — the air-gapped test surface."""

    def __init__(self, config: dict, streams: Sequence[str], *,
                 job_id: str, region: str,
                 credentials: Any = None,
                 env_vars: dict[str, str] | None = None,
                 project: str | None = None,
                 jobs_client: Any = None,
                 logs_lister: Any = None,
                 logs_timeout_s: float = 300.0):
        import base64
        import zlib

        self.config = config
        self.streams = list(streams)
        self.job_id = job_id
        self.region = region
        self.env_vars = dict(env_vars or {})
        self.state: Any = None
        self._cached_catalog_b64: str | None = None
        self.logs_timeout_s = logs_timeout_s
        self.project = project or getattr(credentials, "project_id", None)
        if self.project is None:
            # ambient (ADC) credentials carry no project id; the job
            # parent path needs one — fail here, not with a 404 later
            raise ValueError(
                "remote Airbyte execution needs a GCP project id: pass "
                "gcp_project=... (or credentials with project_id)"
            )
        if jobs_client is None or logs_lister is None:
            try:
                import google.cloud.logging as gcp_logging  # type: ignore
                import google.cloud.run_v2 as run_v2  # type: ignore
            except ImportError as exc:
                raise ImportError(
                    "execution_type='remote' needs the google-cloud-run "
                    "and google-cloud-logging SDKs (or injected "
                    "jobs_client/logs_lister doubles)"
                ) from exc
            jobs_client = jobs_client or run_v2.JobsClient(
                credentials=credentials
            )
            if logs_lister is None:
                log_client = gcp_logging.Client(
                    project=self.project, credentials=credentials
                )

                def logs_lister(execution_id):  # noqa: F811
                    return (
                        e.payload
                        for e in log_client.list_entries(
                            filter_=(
                                'labels."run.googleapis.com/'
                                f'execution_name" = {execution_id}'
                            ),
                            page_size=1000,
                        )
                    )
        self.jobs = jobs_client
        self.logs_lister = logs_lister
        payload = {
            "config": (config.get("source") or {}).get("config", {}),
            "streams": self.streams,
        }
        self._config_env = base64.b64encode(
            zlib.compress(json_mod.dumps(payload).encode(), 9)
        ).decode()
        if len(self._config_env) > LogChunkTransport.MAX_ENV_LENGTH:
            raise ValueError(
                "connector config too large for a Cloud Run env var "
                f"({len(self._config_env)} b64 bytes > "
                f"{LogChunkTransport.MAX_ENV_LENGTH})"
            )
        self._create_job()

    @property
    def job_name(self) -> str:
        return (
            f"projects/{self.project}/locations/{self.region}"
            f"/jobs/{self.job_id}"
        )

    def _create_job(self) -> None:
        import base64

        self.maybe_delete_job()
        image = (self.config.get("source") or {})["docker_image"]
        env = [{"name": k, "value": v} for k, v in self.env_vars.items()]
        env.append({"name": "PW_CONFIG", "value": self._config_env})
        env.append({
            "name": "RUNNER_CODE",
            "value": base64.b64encode(
                _REMOTE_RUNNER_SOURCE.encode()
            ).decode(),
        })
        container = {
            # the override at run time targets the container by NAME (a
            # DNS_LABEL) — the image string is not a valid name
            "name": "connector",
            "image": image,
            "command": ["/bin/sh"],
            "args": [
                "-c",
                " && ".join([
                    "echo $RUNNER_CODE > runner.txt",
                    "base64 -d < runner.txt > runner.py",
                    "python3 runner.py",
                ]),
            ],
            "env": env,
            "resources": {"limits": {"memory": "512Mi", "cpu": "1"}},
        }
        self.jobs.create_job(
            job={"template": {"template": {
                "containers": [container],
                "timeout": {"seconds": 3600},
                "max_retries": 0,
            }}},
            job_id=self.job_id,
            parent=f"projects/{self.project}/locations/{self.region}",
        ).result()

    def maybe_delete_job(self) -> None:
        try:
            self.jobs.delete_job(name=self.job_name).result()
        except Exception:  # noqa: BLE001 - absent job / NotFound
            pass

    def on_stop(self) -> None:
        self.maybe_delete_job()

    def extract(self, streams: Sequence[str] = ()) -> Iterable[dict]:
        prepared_state = json_mod.dumps(self.state)
        if len(prepared_state) > LogChunkTransport.MAX_ENV_LENGTH:
            raise ValueError(
                "incremental state too large for a Cloud Run env var; "
                "use fewer streams per read()"
            )
        overrides = []
        if self.state is not None:
            overrides.append({"name": "AIRBYTE_STATE",
                              "value": prepared_state})
        if self._cached_catalog_b64 is not None:
            overrides.append({"name": "CACHED_CATALOG",
                              "value": self._cached_catalog_b64})
        op = self.jobs.run_job({
            "name": self.job_name,
            "overrides": {"container_overrides": [{
                "name": "connector",
                "env": overrides,
            }]},
        })
        execution_id = op.metadata.name.split("/")[-1]
        result = op.result()
        if getattr(result, "succeeded_count", 1) != 1:
            raise AirbyteSourceError(
                f"Cloud Run execution {execution_id} failed"
            )
        messages = None
        deadline = time_mod.monotonic() + self.logs_timeout_s
        while messages is None:
            transport = LogChunkTransport()
            for payload in self.logs_lister(execution_id):
                transport.append(payload)
            messages = transport.messages()
            if messages is None:
                if time_mod.monotonic() > deadline:
                    raise AirbyteSourceError(
                        f"no complete result in Cloud Logging for "
                        f"execution {execution_id} after "
                        f"{self.logs_timeout_s}s"
                    )
                time_mod.sleep(3.0)
                continue
            self._cached_catalog_b64 = transport.catalog_b64()
        # fail BEFORE committing state: advancing the cursor while
        # discarding the batch's records would silently skip them forever
        for message in messages:
            if (message.get("trace") or {}).get("error"):
                raise AirbyteSourceError(
                    json_mod.dumps(message["trace"]["error"])
                )
        for message in messages:
            if message.get("type") == "STATE":
                self.state = message.get("state")
        return [m for m in messages if m.get("type") == "RECORD"]


def _make_serverless_source(config_file_path, streams, env_vars, enforce_method):
    try:
        import yaml
        from airbyte_serverless.sources import DockerizedSource  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "pw.io.airbyte.read needs the airbyte-serverless package for "
            "local/docker execution (or pass _source=... for an in-process "
            "source)"
        ) from exc
    with open(config_file_path) as f:
        config = yaml.safe_load(f)
    source_config = config["source"]
    return DockerizedSource(
        connector=source_config["docker_image"],
        config=source_config.get("config", {}),
        streams=",".join(streams),
    )


class _AirbyteConnector(BaseConnector):
    def __init__(self, node, source, streams: Sequence[str], mode: str,
                 refresh_interval_ms: int):
        super().__init__(node)
        self.source = source
        self.streams = list(streams)
        self.mode = mode
        self.refresh_interval = refresh_interval_ms / 1000.0
        self._counter = 0
        if mode != "static":
            self.heartbeat_ms = 500

    def _poll_once(self) -> list[tuple[int, tuple, int]]:
        rows = []
        for message in self.source.extract(self.streams):
            record = message.get("record") if isinstance(message, dict) else None
            if record is None:
                continue
            if self.streams and record.get("stream") not in self.streams:
                continue
            key = hash_values("airbyte", self._counter)
            self._counter += 1
            rows.append((key, (Json(record.get("data", {})),), 1))
        return rows

    def run(self) -> None:
        rows = self._poll_once()
        self.commit_rows(rows)
        if self.mode == "static":
            return
        while not self.should_stop():
            time_mod.sleep(self.refresh_interval)
            rows = self._poll_once()
            if rows:
                self.commit_rows(rows)


def read(
    config_file_path: "os.PathLike | str" = "",
    streams: Sequence[str] = (),
    *,
    execution_type: str = "local",
    mode: str = "streaming",
    env_vars: dict[str, str] | None = None,
    service_user_credentials_file: str | None = None,
    gcp_region: str = "europe-west1",
    gcp_job_name: str | None = None,
    gcp_project: str | None = None,
    enforce_method: str | None = None,
    refresh_interval_ms: int = 60000,
    persistent_id: str | None = None,
    _source=None,
) -> Table:
    """Stream Airbyte RECORD messages of the selected ``streams`` into a
    ``data: Json`` table (reference ``io/airbyte/__init__.py:107``)."""
    if _source is None:
        if execution_type == "docker":
            import yaml

            with open(config_file_path) as f:
                config = yaml.safe_load(f)
            source_config = config["source"]
            _source = DockerAirbyteSource(
                source_config["docker_image"],
                source_config.get("config", {}),
                streams,
                env_vars,
            )
        elif execution_type == "remote":
            import yaml

            with open(config_file_path) as f:
                config = yaml.safe_load(f)
            credentials = None
            if service_user_credentials_file is not None:
                from google.oauth2 import service_account  # type: ignore

                credentials = (
                    service_account.Credentials.from_service_account_file(
                        service_user_credentials_file
                    )
                )
            job_id = gcp_job_name or (
                "pathway-airbyte-"
                + format(hash_values(str(config_file_path)) & 0xFFFFFF, "x")
            )
            _source = RemoteAirbyteSource(
                config, streams, job_id=job_id, region=gcp_region,
                credentials=credentials, env_vars=env_vars,
                project=gcp_project,
            )
        elif execution_type != "local":
            raise ValueError(
                f"unknown execution_type {execution_type!r}; expected "
                "'local', 'docker' or 'remote'"
            )
        else:
            _source = _make_serverless_source(
                config_file_path, streams, env_vars, enforce_method
            )
    schema = schema_mod.schema_from_types(data=dt.JSON)
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name=f"airbyte({','.join(streams)})")
    conn = _AirbyteConnector(node, _source, streams, mode, refresh_interval_ms)
    G.register_connector(conn)
    if persistent_id is not None:
        from pathway_tpu_torch.persistence import register_persistent_source

        register_persistent_source(str(persistent_id), conn)
    return Table(node, schema, Universe())
