"""Command-line interface of the port (counterpart of
``pathway_tpu/cli.py``): ``python -m pathway_tpu_torch`` or the
``pathway-tpu-torch`` script.

Carried, with JAX's command names and options:

* ``stats [--url URL] [--as-json]``: the unified observability snapshot
  (serving latency, prefix, spec, occupancy, HBM, scheduler) of a running
  server's ``/v1/statistics``, or of this process's registry;
* ``watch [--url URL] [--interval S] [--iterations N] [--fail-on-alert]``:
  the SLO watchdog's objectives, burn rates and alerts, polled;
* ``fleet serve [--fleet] [-n N] [--host H] [--port P] PROGRAM ARGS...``:
  PROGRAM as N supervised replica processes behind the prefix-affinity
  router (each started with ``--port <its port>`` appended, and JAX's
  environment contract); ``fleet stats --url`` and ``fleet watch --url``
  read a running router's ``/v1/fleet``;
* ``replay [--record-path DIR] [--mode batch|speedrun]
  [--continue-after-replay] PROGRAM ARGS...``: runs the Python file
  PROGRAM (with ``sys.argv`` set to PROGRAM ARGS) in this process against
  a recorded input stream. JAX's command sets the ``PATHWAY_REPLAY_STORAGE``
  family of variables for a spawned program; the port builds the
  ``pw.persistence.Config`` they describe (a filesystem store at DIR,
  snapshot access ``replay``, the mode, stopping at the end of the log
  unless asked to continue) and hands it to every ``pw.run`` of the
  program that is given none (``internals.run.persistence_default``);
* ``spawn [-t N] [-n N] [--first-port P] [--record] [--record-path DIR]
  [--repository-url URL] [--branch B] PROGRAM ARGS...``: N child
  processes, each running the Python file in-process (PROGRAM, or its
  first argument when PROGRAM is a Python interpreter, as in JAX's
  ``spawn python main.py``). JAX's command sets ``PATHWAY_PROCESSES`` /
  ``PATHWAY_PROCESS_ID`` / ``PATHWAY_FIRST_PORT`` / ``PATHWAY_THREADS``
  (and, with ``--record``, the ``PATHWAY_REPLAY_STORAGE`` family) for the
  program and its library reads them; the port's library reads none, so
  each child hands its own ``EngineConfig(processes=, process_id=,
  first_port=, threads=)`` (and the record's ``pw.persistence.Config``) to
  every ``pw.run`` of the program given none
  (``internals.run.config_default``). The children still get JAX's
  variables and the shared ``PATHWAY_RUN_ID``, for programs that read
  them. The exit code is 0 when every child exits 0, else 1. A
  ``--repository-url`` is cloned into a temporary venv as JAX does, which
  needs GitPython (without it the command logs so and exits 1, as JAX's);
* ``spawn-from-env PROGRAM ARGS...``: ``spawn`` with its options read from
  ``PATHWAY_SPAWN_ARGS``.

* ``tune PROFILE [--out PATH] [--seed N] [--trials N] [--scale F]
  [--rounds N] [--smoke] [--device DEV]``: the autotuner
  (``pathway_tpu_torch.tuning``) over one workload profile, its trials on
  the card (``--device cpu`` for the CPU), the winner saved as a
  tuned-config artifact in JAX's format; prints JAX's summary JSON, and on
  stderr how to load the artifact (``tuned_config=<path>``). Exit code 2
  for an unknown profile, 3 when validation rejects every candidate;
* ``airbyte create-source CONNECTION [--image IMAGE]``: JAX's starter YAML
  connection config for an Airbyte source.

JAX's ``PATHWAY_TPU_FLEET`` switch is the ``--fleet`` option here: without
it ``fleet serve`` refuses with exit code 2, as the flag's default does.
JAX's ``PATHWAY_TPU_TUNE_SEED`` / ``PATHWAY_TPU_TUNE_TRIALS`` defaults of
``tune`` are 0 here (the ``Autotuner``'s). The parser is the standard
library's ``argparse`` (JAX's is ``click``). :func:`main` takes ``argv``
(the tests' way in) and returns the exit code.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shlex
import signal
import subprocess
import sys
import time
import urllib.request

from pathway_tpu_torch.internals.config import environ_snapshot, launcher_env

def _out(msg: str = "") -> None:
    print(msg, flush=True)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode())


# ------------------------------------------------------------------- stats

def _section(title: str, rows: dict) -> None:
    if not rows:
        return
    _out(title)
    width = max(len(str(k)) for k in rows)
    for k, v in rows.items():
        _out(f"  {str(k):<{width}}  {v}")


def cmd_stats(args) -> int:
    if args.url is not None:
        snap = _get_json(args.url.rstrip("/") + "/v1/statistics")
    else:
        from pathway_tpu_torch.engine import probes
        from pathway_tpu_torch.internals import run as run_mod

        snap = probes.unified_snapshot(run_mod.LAST_RUN_STATS)
    if args.as_json:
        _out(json.dumps(snap, indent=2, default=str))
        return 0
    serving = snap.get("serving") or {}
    latency = serving.get("latency") or {}
    for name, summary in sorted(latency.items()):
        if summary:
            _section(f"latency/{name} (ms)", summary)
    for key in ("prefix", "spec", "cascade"):
        _section(key, serving.get(key) or {})
    attn = serving.get("attn") or {}
    _section("attn", attn if attn.get("total_bytes") else {})
    for key in ("dispatch", "stage_seconds", "occupancy", "lanes", "tenants"):
        _section(key, serving.get(key) or {})
    _section("kv_parked_bytes",
             {k: v for k, v in (serving.get("kv_parked_bytes") or {}).items() if v})
    _section("retrieval", serving.get("retrieval") or {})
    hbm = snap.get("hbm") or {}
    _section("hbm_bytes", hbm.get("current_bytes") or {})
    for dev, comps in sorted((hbm.get("device_bytes") or {}).items()):
        _section(f"hbm_bytes/device={dev}", comps)
    _section("hbm_high_water_bytes/device", hbm.get("per_device_high_water_bytes") or {})
    sched = snap.get("scheduler") or {}
    if sched:
        _section("scheduler", {k: sched[k] for k in
                               ("current_time", "epochs_total", "uptime_s", "finished")
                               if k in sched})
    if not any((latency, serving.get("prefix"), serving.get("spec"), serving.get("cascade"),
                attn.get("total_bytes"), serving.get("dispatch"),
                serving.get("stage_seconds"), serving.get("occupancy"),
                hbm.get("current_bytes"), sched)):
        _out("no metrics recorded yet")
    return 0


# ------------------------------------------------------------------- watch

def _watch_pass(url: str | None) -> tuple[dict, dict]:
    if url is not None:
        snap = _get_json(url.rstrip("/") + "/v1/statistics")
        return snap.get("slo") or {}, snap.get("serving") or {}
    from pathway_tpu_torch.engine import probes, slo

    wd = slo.get_watchdog()
    state = wd.tick() if wd.objectives else wd.state()
    return state, probes.serving_snapshot()


def cmd_watch(args) -> int:
    n = 0
    state: dict = {}
    try:
        while True:
            state, serving = _watch_pass(args.url)
            n += 1
            objectives = state.get("objectives") or {}
            if not objectives:
                _out("no SLO objectives configured (engine.slo.configure thresholds)")
            else:
                alerting = state.get("alerting") or []
                _out(f"[{time.strftime('%H:%M:%S')}] slo: "
                     + ("ALERT " + ",".join(alerting) if alerting else "ok"))
                for name, o in sorted(objectives.items()):
                    value = o.get("value")
                    vtxt = (f"{value:.3f}{o.get('unit', '')}"
                            if isinstance(value, (int, float)) else "-")
                    mark = "!" if o.get("alert") else " "
                    _out(f" {mark} {name:<16} value={vtxt:<12} "
                         f"target {o['kind']} {o['threshold']} "
                         f"burn fast={o['burn_fast']:.2f} slow={o['burn_slow']:.2f} "
                         f"breaches={o['breaches']}")
            lanes = serving.get("lanes") or {}
            tenants = serving.get("tenants") or {}
            if lanes:
                _out("   lanes: " + " ".join(f"{k}={v:.0f}" for k, v in sorted(lanes.items())))
            if tenants:
                _out("   tenants queued: "
                     + " ".join(f"{k}={v:.0f}" for k, v in sorted(tenants.items())))
            if args.iterations and n >= args.iterations:
                break
            time.sleep(max(args.interval, 0.05))
    except KeyboardInterrupt:
        pass
    return 1 if args.fail_on_alert and state.get("alerting") else 0


# ------------------------------------------------------------------- fleet

def cmd_fleet_serve(args) -> int:
    import os
    import uuid

    from pathway_tpu_torch import serving
    from pathway_tpu_torch.serving.replica import HttpReplica, free_port, spawn_replica_process

    if not args.fleet:
        _err("fleet serving is off (pass --fleet to serve a fleet; the single-server "
             "path is unchanged)")
        return 2
    serving.configure(enabled=True)
    run_id = str(uuid.uuid4())
    next_index = [0]
    logs = []

    def factory(replica_id: str):
        idx = next_index[0]
        next_index[0] += 1
        rport = free_port(args.host)
        out = None
        if args.replica_log_dir:
            os.makedirs(args.replica_log_dir, exist_ok=True)
            out = open(os.path.join(args.replica_log_dir, f"replica-{idx}.log"), "ab")
            logs.append(out)
        proc = spawn_replica_process(
            [args.program, *args.arguments, "--port", str(rport)],
            replica_index=idx, port=rport, run_id=run_id, stdout=out, stderr=out)
        return HttpReplica(replica_id, f"http://{args.host}:{rport}", proc=proc)

    kw = {"boot_grace_s": args.boot_grace}
    if args.replicas is not None:
        kw["replicas"] = args.replicas
    if args.health_interval is not None:
        kw["health_interval_s"] = args.health_interval
    manager = serving.build_fleet(factory, **kw)
    router_srv = serving.RouterServer(manager.router, manager=manager, host=args.host,
                                      port=args.port).start()
    manager.run_in_thread()
    _err(f"fleet router on http://{args.host}:{router_srv.port} "
         f"({len(manager.router)} replicas, run {run_id})")

    def on_term(signum, frame):
        raise KeyboardInterrupt

    # SIGTERM ends the fleet as Ctrl-C does: the replicas are stopped too
    prev = signal.signal(signal.SIGTERM, on_term)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        router_srv.stop()
        manager.shutdown()
        for f in logs:
            f.close()
    return 0


def cmd_fleet_stats(args) -> int:
    state = _get_json(args.url.rstrip("/") + "/v1/fleet")
    if args.as_json:
        _out(json.dumps(state, indent=2, default=str))
        return 0
    _out(f"fleet size {state.get('size')} (min {state.get('min')} / max {state.get('max')}), "
         f"burn {state.get('burn', 0.0):.2f}, respawns {state.get('respawns', 0)}")
    for rid, info in sorted((state.get("replicas") or {}).items()):
        _out(f"  {rid:<14} kind={info.get('kind', '?'):<7} "
             f"fails={info.get('consecutive_failures', 0)}")
    events = state.get("events") or []
    if events:
        _out("recent events:")
        for kind, rid in events[-10:]:
            _out(f"  {kind} {rid if rid else ''}")
    return 0


def cmd_fleet_watch(args) -> int:
    endpoint = args.url.rstrip("/") + "/v1/fleet"
    n = 0
    try:
        while True:
            state = _get_json(endpoint)
            n += 1
            _out(f"[{time.strftime('%H:%M:%S')}] size={state.get('size')} "
                 f"burn={state.get('burn', 0.0):.2f} respawns={state.get('respawns', 0)} "
                 f"members={','.join(state.get('ring_members') or [])}")
            if args.iterations and n >= args.iterations:
                break
            time.sleep(max(args.interval, 0.05))
    except KeyboardInterrupt:
        pass
    return 0


# ------------------------------------------------------------------ parser

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pathway-tpu-torch",
                                     description="pathway_tpu_torch command line")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("stats", help="pretty-print the unified observability snapshot")
    p.add_argument("--url", default=None, metavar="URL",
                   help="base URL of a running server (fetches URL/v1/statistics); omit to "
                        "read this process's in-memory registry")
    p.add_argument("--as-json", action="store_true", help="dump the raw snapshot as JSON")
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser("watch", help="live SLO watchdog view")
    p.add_argument("--url", default=None, metavar="URL",
                   help="base URL of a running server (fetches URL/v1/statistics)")
    p.add_argument("--interval", type=float, default=2.0, help="seconds between evaluations")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N evaluations (0 = run until interrupted)")
    p.add_argument("--fail-on-alert", action="store_true",
                   help="exit nonzero if any SLO alert is firing at the end")
    p.set_defaults(func=cmd_watch)

    fleet = sub.add_parser("fleet", help="replicated serving fleet")
    fsub = fleet.add_subparsers(dest="fleet_command", required=True)
    p = fsub.add_parser("serve", help="run PROGRAM as N supervised replicas behind the router")
    p.add_argument("--fleet", action="store_true",
                   help="switch fleet serving on (off by default, as in JAX)")
    p.add_argument("-n", "--replicas", type=int, default=None, metavar="N",
                   help="initial replica count [default: 2]")
    p.add_argument("--host", default="127.0.0.1", help="router bind host")
    p.add_argument("--port", type=int, default=0, help="router bind port (0 = ephemeral)")
    p.add_argument("--health-interval", type=float, default=None, metavar="S",
                   help="seconds between supervisor ticks [default: 0.5]")
    p.add_argument("--boot-grace", type=float, default=120.0, metavar="S",
                   help="seconds a never-yet-ready replica may spend booting before failed "
                        "health probes count toward draining it")
    p.add_argument("--replica-log-dir", default=None, metavar="DIR",
                   help="write each replica's output to DIR/replica-<i>.log")
    p.add_argument("program")
    p.add_argument("arguments", nargs=argparse.REMAINDER)
    p.set_defaults(func=cmd_fleet_serve)
    p = fsub.add_parser("stats", help="one-shot fleet state")
    p.add_argument("--url", required=True, metavar="URL",
                   help="base URL of a running fleet router (fetches URL/v1/fleet)")
    p.add_argument("--as-json", action="store_true", help="dump the raw state as JSON")
    p.set_defaults(func=cmd_fleet_stats)
    p = fsub.add_parser("watch", help="poll a fleet router's state")
    p.add_argument("--url", required=True, metavar="URL",
                   help="base URL of a running fleet router")
    p.add_argument("--interval", type=float, default=2.0, help="seconds between polls")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N polls (0 = run until interrupted)")
    p.set_defaults(func=cmd_fleet_watch)

    p = sub.add_parser("replay", help="replay PROGRAM against a recorded input stream")
    p.add_argument("--record-path", default="record",
                   help="directory from which the record is replayed")
    p.add_argument("--mode", choices=["batch", "speedrun"], default="batch", help="replay mode")
    p.add_argument("--continue-after-replay", action="store_true",
                   help="keep processing live data after the replay finishes")
    p.add_argument("program", help="the Python file to run")
    p.add_argument("arguments", nargs=argparse.REMAINDER)
    p.set_defaults(func=cmd_replay)

    p = sub.add_parser("spawn", help="launch PROGRAM as a multi-process run")
    p.add_argument("-t", "--threads", metavar="N", type=int, default=1,
                   help="number of threads per process")
    p.add_argument("-n", "--processes", metavar="N", type=int, default=1,
                   help="number of processes")
    p.add_argument("--first-port", type=int, metavar="PORT", default=10000,
                   help="first port of the processes' exchange")
    p.add_argument("--record", action="store_true", help="record data in the input connectors")
    p.add_argument("--record-path", default="record",
                   help="directory in which the record is saved")
    p.add_argument("--repository-url", default=None,
                   help="github repository to spawn the program from")
    p.add_argument("--branch", default=None, help="branch if not the default")
    p.add_argument("program", help="the Python file to run (or a Python interpreter and it)")
    p.add_argument("arguments", nargs=argparse.REMAINDER)
    p.set_defaults(func=cmd_spawn)

    p = sub.add_parser("spawn-from-env",
                       help="spawn with the options in $PATHWAY_SPAWN_ARGS")
    p.add_argument("program")
    p.add_argument("arguments", nargs=argparse.REMAINDER)
    p.set_defaults(func=cmd_spawn_from_env)

    p = sub.add_parser("tune", help="search the tunable knobs for a workload PROFILE")
    p.add_argument("profile")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the winning tuned-config JSON here "
                        "[default: tuned-<profile>.json]")
    p.add_argument("--seed", type=int, default=None, help="search seed [default: 0]")
    p.add_argument("--trials", type=int, default=None,
                   help="cap the candidate pool (baseline + N-1 candidates) "
                        "[default: 0 = full ladder]")
    p.add_argument("--scale", type=float, default=1.0,
                   help="trace-scale multiplier for the first halving round [default: 1.0]")
    p.add_argument("--rounds", type=int, default=3,
                   help="successive-halving rounds [default: 3]")
    p.add_argument("--smoke", action="store_true",
                   help="seconds-scale CI invocation: 2 trials, 1 round, half-scale traces")
    p.add_argument("--device", default=None,
                   help="where the trials run [default: the CUDA card]; cpu for the CPU")
    p.set_defaults(func=cmd_tune)

    airbyte = sub.add_parser("airbyte", help="Airbyte connector scaffolding")
    asub = airbyte.add_subparsers(dest="airbyte_command", required=True)
    p = asub.add_parser("create-source",
                        help="write a starter YAML connection config for an Airbyte source")
    p.add_argument("connection")
    p.add_argument("--image", default="airbyte/source-faker:0.1.4",
                   help="any public Docker Airbyte source image")
    p.set_defaults(func=cmd_airbyte_create_source)
    return parser


def replay_config(record_path: str, mode: str = "batch",
                  continue_after_replay: bool = False):
    """The persistence Config of ``replay`` (what JAX's command puts in
    the environment)."""
    from pathway_tpu_torch import persistence

    return persistence.Config(
        backend=persistence.Backend.filesystem(record_path),
        persistence_mode="speedrun_replay" if mode == "speedrun" else mode,
        snapshot_access="replay",
        # replay-only runs stop at the end of the log unless asked to continue
        continue_after_replay=continue_after_replay,
    )


def cmd_replay(args) -> int:
    import runpy

    from pathway_tpu_torch.internals import run as run_mod

    cfg = replay_config(args.record_path, args.mode, args.continue_after_replay)
    argv = sys.argv
    sys.argv = [args.program, *args.arguments]
    try:
        with run_mod.persistence_default(cfg):
            runpy.run_path(args.program, run_name="__main__")
    finally:
        sys.argv = argv
    return 0


# ------------------------------------------------------------------- spawn

# what a spawned child runs: the program file in-process under its config
_CHILD = ("import sys; from pathway_tpu_torch.cli import run_child; "
          "sys.exit(run_child(sys.argv[1], sys.argv[2], sys.argv[3:]))")


def _program_file(program: str, arguments: list[str]) -> tuple[str, list[str]]:
    """The Python file to run and its arguments: ``PROGRAM ARGS`` where
    PROGRAM is the file, or ``python FILE ARGS`` (JAX's usual form)."""
    if os.path.basename(program).startswith("python") and arguments:
        return arguments[0], list(arguments[1:])
    return program, list(arguments)


def spawn_program(*, threads: int, processes: int, first_port: int, program: str,
                  arguments, record: bool = False, record_path: str = "record",
                  repository_url: str | None = None, branch: str | None = None) -> int:
    """Start ``processes`` children of one run and wait for them all;
    returns 0 when every child exited 0, else 1."""
    import uuid

    python = sys.executable
    if repository_url is not None:
        try:
            import git
        except ImportError:
            logging.error("To run the code from a Git repository please install GitPython")
            return 1
        import tempfile
        import venv

        # JAX's checkout: the repository in a temporary directory with a
        # fresh venv holding its requirements; the children run there
        root = tempfile.mkdtemp(prefix="pathway-spawn-")
        repo_dir, venv_dir = os.path.join(root, "repository"), os.path.join(root, "venv")
        repo = git.Repo.clone_from(repository_url, repo_dir)
        if branch is not None:
            repo.git.checkout(branch)
        venv.create(venv_dir, with_pip=True)
        requirements = os.path.join(repo_dir, "requirements.txt")
        if os.path.exists(requirements):
            if subprocess.run([os.path.join(venv_dir, "bin", "pip"), "install", "-r",
                               requirements], stderr=subprocess.STDOUT).returncode:
                raise RuntimeError("Failed to install dependencies")
        python = os.path.join(venv_dir, "bin", "python")
        os.chdir(repo_dir)
    path, args = _program_file(program, list(arguments))
    run_id = str(uuid.uuid4())
    _err(f"Preparing {processes} process{'' if processes == 1 else 'es'} "
         f"({processes * threads} total worker{'' if processes * threads == 1 else 's'})")
    children: list[subprocess.Popen] = []
    try:
        for pid in range(processes):
            spec = dict(threads=threads, processes=processes, process_id=pid,
                        first_port=first_port, record_path=record_path if record else None)
            env = environ_snapshot(PATHWAY_THREADS=str(threads),
                                   PATHWAY_PROCESSES=str(processes),
                                   PATHWAY_FIRST_PORT=str(first_port),
                                   PATHWAY_PROCESS_ID=str(pid), PATHWAY_RUN_ID=run_id)
            if record:
                env.update(PATHWAY_REPLAY_STORAGE=record_path, PATHWAY_SNAPSHOT_ACCESS="record")
            children.append(subprocess.Popen(
                [python, "-c", _CHILD, json.dumps(spec), path, *args], env=env))
        for child in children:
            child.wait()
    finally:
        for child in children:
            if child.poll() is None:
                child.terminate()
                child.wait()
    # a child killed by a signal has a negative code: any non-zero fails the run
    return 0 if all(c.returncode == 0 for c in children) else 1


def record_config(record_path: str):
    """The persistence Config of ``spawn --record`` (what JAX builds from
    ``PATHWAY_REPLAY_STORAGE`` and ``PATHWAY_SNAPSHOT_ACCESS=record``)."""
    from pathway_tpu_torch import persistence

    return persistence.Config(backend=persistence.Backend.filesystem(record_path),
                              snapshot_access="record", continue_after_replay=True)


def run_child(spec_json: str, path: str, arguments) -> int:
    """One spawned child: ``path`` run as ``__main__`` with ``sys.argv`` set
    to it and its arguments, every ``pw.run`` given no config taking this
    child's ``EngineConfig`` (and, when recording, the record's Config)."""
    import contextlib
    import runpy

    from pathway_tpu_torch.internals import config as config_mod
    from pathway_tpu_torch.internals import run as run_mod

    spec = json.loads(spec_json)
    cfg = config_mod.EngineConfig(processes=spec["processes"], process_id=spec["process_id"],
                                  first_port=spec["first_port"], threads=spec["threads"])
    sys.argv = [path, *arguments]
    with contextlib.ExitStack() as stack:
        stack.enter_context(run_mod.config_default(cfg))
        if spec["record_path"] is not None:
            stack.enter_context(run_mod.persistence_default(record_config(spec["record_path"])))
        runpy.run_path(path, run_name="__main__")
    return 0


def cmd_spawn(args) -> int:
    return spawn_program(threads=args.threads, processes=args.processes,
                         first_port=args.first_port, program=args.program,
                         arguments=args.arguments, record=args.record,
                         record_path=args.record_path, repository_url=args.repository_url,
                         branch=args.branch)


def cmd_spawn_from_env(args) -> int:
    argv = [*shlex.split(launcher_env("PATHWAY_SPAWN_ARGS") or ""), args.program,
            *args.arguments]
    return main(["spawn", *argv])


# -------------------------------------------------------------------- tune

def cmd_tune(args) -> int:
    """Search the tunable knobs for a workload profile, validate survivors
    under the SLO watchdog and a chaos drill, and save the winner as a
    tuned-config artifact. Exit code 2 for an unknown profile, 3 when
    validation rejects every candidate (the defaults stay in force)."""
    from pathway_tpu_torch import tuning

    profile = args.profile
    if profile not in tuning.PROFILES:
        _err(f"unknown profile {profile!r}; available: {sorted(tuning.PROFILES)}")
        return 2
    trials, rounds, scale = args.trials, args.rounds, args.scale
    if args.smoke:
        trials = 2 if trials is None else trials
        rounds = min(rounds, 1)
        scale = min(scale, 0.5)
    tuner = tuning.Autotuner(profile, seed=args.seed or 0, max_trials=trials or 0,
                             base_scale=scale, rounds=rounds, device=args.device)
    try:
        result = tuner.run()
    except tuning.TuneError as exc:
        _err(f"tune failed: {exc}")
        return 3
    path = args.out or f"tuned-{profile}.json"
    tuning.save_artifact(result, path)
    art = tuning.to_artifact(result)
    _out(json.dumps({
        "profile": art["profile"],
        "headline": art["headline"],
        "direction": art["direction"],
        "flags": art["flags"],
        "score": art["score"],
        "baseline_score": art["baseline_score"],
        "trials": len(result.trials),
        "rejected": len(result.rejected),
        "artifact": path,
    }, indent=2, sort_keys=True))
    _err(f"load it with tuned_config={path!r} (DecoderChat, SentenceEmbedderModel, "
         f"QueryServer, EngineConfig)")
    return 0


# ----------------------------------------------------------------- airbyte

def cmd_airbyte_create_source(args) -> int:
    """JAX's scaffold: a starter YAML connection config for an Airbyte
    source. Running the source itself needs docker or a local connector;
    the scaffold is written here."""
    import pathlib

    path = pathlib.Path(args.connection)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        "source:\n"
        f"  docker_image: {args.image}\n"
        "  config:\n"
        "    # fill in source-specific configuration here\n"
        "streams: []\n"
    )
    _out(f"Connection `{path.stem}` with source `{args.image}` created successfully")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
