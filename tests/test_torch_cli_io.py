"""The CLI's ``spawn`` / ``spawn-from-env``, ``pw.debug``'s CSV and
parquet helpers, ``pw.io.kafka.simple_read`` / ``read_from_upstash`` and
``pw.io.python.InteractiveCsvPlayer`` of the port against the JAX
package's, on the CPU.

``spawn`` starts its children as JAX's does, but each runs the program
file in-process with its own ``EngineConfig`` handed to every ``pw.run``
given none (the port's library reads no variable); the children also get
JAX's variables for programs that read them, so ``tests/test_cli.py``'s
programs run unchanged. Every child wait is bounded.
"""

import json
import os
import subprocess
import sys
import types

import pandas as pd
import pytest

import pathway_tpu as JPW
from pathway_tpu_torch import cli as tcli
from tests.test_real_backends import _StubConsumer, _StubMessage
from tests.torch_engine import PACKAGES, PW, final_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
PRINT_ENV = (  # tests/test_cli.py's program
    "import os;"
    "os.write(1, (' '.join([os.environ['PATHWAY_PROCESS_ID'],"
    " os.environ['PATHWAY_PROCESSES'], os.environ['PATHWAY_THREADS'],"
    " os.environ['PATHWAY_FIRST_PORT']]) + '\\n').encode())"
)
PRINT_CONFIG = """
import os
from pathway_tpu_torch.internals import run
c = run._DEFAULT_CONFIG
os.write(1, f"{c.process_id} {c.processes} {c.threads} {c.first_port}\\n".encode())
"""


@pytest.fixture
def cli(capfd, monkeypatch):
    """``pathway-tpu-torch ARGV`` in this process (its children are real
    processes, which find the repository on ``PYTHONPATH``): the exit code
    and what the children wrote to stdout and stderr."""
    monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def run(*argv, env=None):
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        capfd.readouterr()
        code = tcli.main(list(argv))
        out, err = capfd.readouterr()
        return types.SimpleNamespace(returncode=code, stdout=out, stderr=err)

    return run


def _free_port(n: int = 2) -> int:
    """A base port with ``n`` consecutive free ports: spawned process ``i``
    binds ``first_port + i``."""
    import socket

    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        held = [s]
        try:
            for p in range(base + 1, base + n):
                t = socket.socket()
                held.append(t)
                t.bind(("127.0.0.1", p))
            return base
        except (OSError, OverflowError):
            continue
        finally:
            for t in held:
                t.close()


# ------------------------------------------------------------------- spawn


def test_cli_lists_only_tune_and_airbyte_unported():
    """Every JAX command is ported: ``tune`` and ``airbyte``, the last two,
    are commands of their own and the not-ported table is gone."""
    assert not hasattr(tcli, "NOT_PORTED")
    commands = set(tcli.build_parser()._subparsers._group_actions[0].choices)
    assert {"spawn", "spawn-from-env", "replay", "tune", "airbyte"} <= commands


@pytest.mark.parametrize("processes", [1, 2])
def test_spawn_hands_each_child_its_config_and_jax_variables(cli, tmp_path, processes):
    """``tests/test_cli.py::test_spawn_sets_topology_env`` with both
    contracts: JAX's variables and the port's ``EngineConfig``."""
    script = tmp_path / "prog.py"
    script.write_text(PRINT_ENV + "\n" + PRINT_CONFIG)
    out = cli("spawn", "-t", "2", "-n", str(processes), "--first-port", "12345",
               sys.executable, str(script))
    assert out.returncode == 0, out.stderr
    want = [f"{p} {processes} 2 12345" for p in range(processes)]
    assert sorted(out.stdout.strip().splitlines()) == sorted(want * 2)


def test_spawn_record_flag(cli, tmp_path):
    script = tmp_path / "prog.py"
    script.write_text(
        "import os\nfrom pathway_tpu_torch.internals import run\n"
        "c = run._DEFAULT_PERSISTENCE\n"
        "print(os.environ.get('PATHWAY_REPLAY_STORAGE'), os.environ.get("
        "'PATHWAY_SNAPSHOT_ACCESS'), c.backend.kind, c.snapshot_access)\n")
    out = cli("spawn", "--record", "--record-path", "recdir", sys.executable, str(script))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "recdir record filesystem record"


def test_spawn_from_env(cli, tmp_path):
    script = tmp_path / "prog.py"
    script.write_text(PRINT_ENV + "\n" + PRINT_CONFIG)
    out = cli("spawn-from-env", sys.executable, str(script), env={"PATHWAY_SPAWN_ARGS": "-t 3"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == ["0 1 3 10000"] * 2


@pytest.mark.parametrize("processes", [1, 2])
def test_cli_spawn_runs_program(tmp_path, processes):
    """``tests/test_debug_monitor_matrix.py::test_cli_spawn_runs_program``:
    a ``pw.debug`` program under ``python -m pathway_tpu_torch spawn``."""
    prog = tmp_path / "p.py"
    prog.write_text(
        "import pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_markdown('a\\n1')\n"
        "pw.debug.compute_and_print(t, include_id=False)\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "spawn", "--threads", "1",
                        "-n", str(processes), "--first-port", str(_free_port()),
                        sys.executable, str(prog)],
                       capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    assert "1" in r.stdout


WORDCOUNT = """
import sys
import pathway_tpu_torch as pw

class S(pw.Schema):
    word: str

t = pw.io.jsonlines.read(sys.argv[1], schema=S, mode="static")
counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
pw.io.jsonlines.write(counts, sys.argv[2])
pw.run()
"""


def test_spawn_two_processes_run_one_program_over_the_exchange(cli, tmp_path):
    """Two spawned children run one program over the row exchange (their
    ``pw.run()`` takes no config): the folded shards equal the JAX
    package's one-process run."""
    data = tmp_path / "in"
    data.mkdir()
    words = ["alpha", "beta", "gamma", "delta"]
    for i in range(6):
        (data / f"f{i}.jsonl").write_text("".join(
            json.dumps({"word": words[(i + j) % 4]}) + "\n" for j in range(i + 1)))
    prog = tmp_path / "wc.py"
    prog.write_text(WORDCOUNT)
    r = cli("spawn", "-n", "2", "--first-port", str(_free_port()), str(prog), str(data),
            str(tmp_path / "out.jsonl"))
    assert r.returncode == 0, r.stderr[-2000:]
    net = {}
    for p in range(2):
        with open(tmp_path / f"out.jsonl.{p}") as f:
            for line in f:
                row = json.loads(line)
                net[(row["word"], row["c"])] = net.get((row["word"], row["c"]), 0) + row["diff"]
    got = {w: c for (w, c), n in net.items() if n}

    JPW.clear_graph()
    t = JPW.io.jsonlines.read(str(data), schema=JPW.schema_from_types(word=str), mode="static")
    rows, _ = final_state("jax", t.groupby(t.word).reduce(t.word, c=JPW.reducers.count()))
    assert got == {w: c for w, c in rows.values()} and sum(got.values()) == 21


def test_spawn_exit_codes(cli, tmp_path, caplog):
    """Any child that fails fails the run (JAX's rule); a repository needs
    GitPython, which is not installed: logged, exit code 1."""
    prog = tmp_path / "p.py"
    prog.write_text("import os, sys\nsys.exit(int(os.environ['PATHWAY_PROCESS_ID']) == 1)\n")
    assert cli("spawn", "-n", "2", str(prog)).returncode == 1
    assert cli("spawn", "--repository-url", "https://example.invalid/r.git",
               str(prog)).returncode == 1
    assert "GitPython" in caplog.text


# ------------------------------------------------------------------- pw.debug


def _markdown(pw):
    pw.clear_graph()
    return pw.debug.table_from_markdown("""
        a | b   | c
        1 | x   | 1.5
        2 | y   | 2.5
        3 | zed | -1.0
        """)


def test_table_to_csv_parquet_roundtrip_matches_jax(tmp_path):
    """``tests/test_debug_monitor_matrix.py::test_table_to_csv_parquet_roundtrip``
    in both packages: the CSV files are byte-equal, the parquet files read
    back to equal frames, and each file read back by each package gives
    the same table."""
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.debug.table_to_csv(_markdown(pw), str(tmp_path / f"{pkg}.csv"))
        pw.debug.table_to_parquet(_markdown(pw), str(tmp_path / f"{pkg}.parquet"))
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    df = pd.read_csv(tmp_path / "torch.csv")
    assert sorted(df["a"].tolist()) == [1, 2, 3]
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "torch.parquet"),
                                  pd.read_parquet(tmp_path / "jax.parquet"))
    for kind in ("csv", "parquet"):
        states = {}
        for pkg in PACKAGES:
            pw = PW[pkg]
            pw.clear_graph()
            reader = pw.debug.table_from_csv if kind == "csv" else pw.debug.table_from_parquet
            states[pkg] = final_state(pkg, reader(str(tmp_path / f"torch.{kind}")))
        assert states["torch"] == states["jax"] and len(states["torch"][0]) == 3


# ------------------------------------------------------------------- kafka


def _run_rows(pkg, build):
    pw = PW[pkg]
    pw.clear_graph()
    rows, _ = final_state(pkg, build(pw))
    return sorted(rows.values())


def test_simple_read_over_the_broker_matches_jax():
    payloads = [json.dumps({"word": w, "n": i}).encode() for i, w in enumerate("abcab")]
    out = {}
    for pkg in PACKAGES:
        for fmt in ("raw", "json"):
            broker = PW[pkg].io.kafka.InMemoryKafkaBroker()
            for p in payloads:
                broker.produce("t", p)
            broker.close()

            def build(pw, broker=broker, fmt=fmt):
                schema = None if fmt == "raw" else pw.schema_from_types(word=str, n=int)
                return pw.io.kafka.simple_read(broker, "t", schema=schema, format=fmt)

            out[(pkg, fmt)] = _run_rows(pkg, build)
    assert out[("torch", "raw")] == out[("jax", "raw")] and len(out[("torch", "raw")]) == 5
    assert out[("torch", "json")] == out[("jax", "json")]
    assert sorted(r[1] for r in out[("torch", "json")]) == [0, 1, 2, 3, 4]


@pytest.fixture
def recording_confluent(monkeypatch):
    """The stubbed ``confluent_kafka`` of ``tests/test_real_backends.py``,
    recording each consumer's settings."""
    seen = []

    class Consumer(_StubConsumer):
        def __init__(self, settings):
            super().__init__(settings)
            seen.append(dict(settings))

    mod = types.ModuleType("confluent_kafka")
    mod.Consumer = Consumer
    monkeypatch.setitem(sys.modules, "confluent_kafka", mod)
    return seen


def _stream_until(pkg, build, n):
    import threading
    import time

    pw = PW[pkg]
    pw.clear_graph()
    t = build(pw)
    rows = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(
        tuple(row.values())))
    conns = list(pw.G.connectors)

    def stopper():
        deadline = time.monotonic() + 30
        while len(rows) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        for c in conns:
            c._stop.set()
            c.close()

    th = threading.Thread(target=stopper, daemon=True)
    th.start()
    pw.run()
    th.join(30)
    assert not th.is_alive()
    return sorted(rows)


@pytest.mark.parametrize("which", ["simple_read", "read_from_upstash"])
def test_kafka_settings_readers_match_jax(recording_confluent, which):
    """Both readers build JAX's consumer settings and read the stub
    broker's messages as JAX's do."""
    out = {}
    for pkg in PACKAGES:
        _StubConsumer.MESSAGES = [_StubMessage(json.dumps({"word": w}).encode(), 0, i)
                                  for i, w in enumerate(["cat", "dog", "cat"])]

        def build(pw):
            schema = pw.schema_from_types(word=str)
            if which == "simple_read":
                return pw.io.kafka.simple_read("stub:9092", "words", schema=schema,
                                               format="json")
            return pw.io.kafka.read_from_upstash("stub:9092", "user", "secret", "words",
                                                 schema=schema, format="json",
                                                 read_only_new=True)

        out[pkg] = _stream_until(pkg, build, 3)
    assert out["torch"] == out["jax"] == [("cat",), ("cat",), ("dog",)]
    jax_cfg, torch_cfg = ({k: v for k, v in s.items() if k != "group.id"}
                          for s in recording_confluent)
    assert torch_cfg == jax_cfg and torch_cfg["bootstrap.servers"] == "stub:9092"


# ------------------------------------------------------------------- python


def test_interactive_csv_player_plays_the_file_as_jax(tmp_path):
    """Without ``panel`` / ``IPython`` the player releases every row at
    once, as JAX's: both packages' tables hold the CSV's rows."""
    path = tmp_path / "rows.csv"
    pd.DataFrame({"name": ["a", "b", "c"], "v": [1, 2, 3]}).to_csv(path, index=False)
    out = {}
    for pkg in PACKAGES:
        def build(pw):
            player = pw.io.python.InteractiveCsvPlayer(str(path))
            assert not player._widgets
            return pw.io.python.read(player, schema=pw.schema_from_types(name=str, v=int))

        out[pkg] = _run_rows(pkg, build)
    assert out["torch"] == out["jax"] == [("a", 1), ("b", 2), ("c", 3)]
