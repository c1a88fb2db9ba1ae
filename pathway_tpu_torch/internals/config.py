"""The dataflow engine's switches (counterpart of the engine flags of
``pathway_tpu/internals/config.py``), as one value ``pw.run`` takes.

Each field is a JAX ``PATHWAY_*`` / ``PATHWAY_TPU_*`` flag with the JAX
default; the port reads no flag from the environment (its few
environment reads go through ``env_interpolate``, ``environ_snapshot`` and
``launcher_env`` below). ``pw.run(config=...)``
installs a config for that run and restores the one before it after;
``active()`` is what the scheduler and operators read while a run is on
(the defaults outside a run, e.g. for the ``debug`` helpers).

It also holds the tuned-config surface of JAX's module: ``Tunable``, the
knob table (``KNOBS``: each JAX flag the autotuner searches or sets, and
the port argument that stands for it), ``load_tuned_config`` and
``tuned_config_snapshot``. An artifact is applied through the consuming
constructor's ``tuned_config=`` argument.
"""

from __future__ import annotations

import dataclasses
import os


# --------------------------------------------------------------------- #
# tuned configs: the autotuner's knobs and its artifacts
#
# JAX declares every performance knob as a PATHWAY_TPU_* flag and loads a
# tuned-config artifact (`python -m ... tune`) as the lowest-precedence
# value source under the environment. The port reads no environment: each
# knob is an argument of the object that consumes it, and an artifact is
# applied by passing its path as that object's ``tuned_config=``. The order
# is JAX's (override > env > tuned > default) with the env step dropped: an
# argument the caller passes beats the artifact, which beats the default.
# Artifacts keep JAX's format (version 1, JAX's flag names as keys), so an
# artifact written by either package loads in the other.

_TRUTHY = ("1", "true", "yes", "on")


def _parse_int8(raw: str) -> str:
    """JAX's ``_parse_weight_quant``: ``int8`` or any truthy spelling
    enables int8 weights; every other value (``0`` included) is full
    precision, spelled ``""``."""
    return "int8" if raw.strip().lower() in (*_TRUTHY, "int8") else ""


@dataclasses.dataclass(frozen=True)
class Tunable:
    """Search-space declaration for one knob (a copy of JAX's): ``kind``
    is ``"int"`` / ``"float"`` (a ``[lo, hi]`` range walked additively by
    ``step``, or by doubling when ``log=True``) or ``"choice"`` (an
    explicit value tuple)."""

    kind: str = "int"  # "int" | "float" | "choice"
    lo: float | None = None
    hi: float | None = None
    step: float | None = None
    log: bool = False
    choices: tuple = ()

    def candidates(self) -> tuple[str, ...]:
        """The deterministic candidate ladder, as raw strings (fed
        through the knob's own parser)."""
        if self.kind == "choice":
            return tuple(str(c) for c in self.choices)
        vals: list[float] = []
        v = float(self.lo)
        while v <= float(self.hi) + 1e-9:
            vals.append(v)
            v = v * 2.0 if self.log else v + float(self.step or 1)
        if self.kind == "int":
            return tuple(str(int(round(x))) for x in vals)
        return tuple(str(x) for x in vals)

    def contains(self, raw) -> bool:
        """Is ``raw`` (a raw string or a parsed value) inside the space?"""
        if self.kind == "choice":
            return str(raw) in {str(c) for c in self.choices}
        try:
            v = float(raw)
        except (TypeError, ValueError):
            return False
        return float(self.lo) <= v <= float(self.hi)


@dataclasses.dataclass(frozen=True)
class Knob:
    """One JAX flag and the port argument that stands for it: ``target``
    names the consumer (``DecoderChat``, ``SentenceEmbedderModel``,
    ``QueryServer``, ``EngineConfig``, or the module-wide ``chaos`` /
    ``slo`` settings of ``engine/chaos.py`` and ``engine/slo.py``
    ``configure``) and ``arg`` its argument. ``default``, ``kind``,
    ``minimum``, ``parse`` and ``tunable`` are JAX's. A knob with
    ``target=None`` has no counterpart in the port, and an artifact that
    sets it is refused."""

    env: str
    kind: str  # "bool" | "int" | "float" | "str"
    default: object
    target: str | None
    arg: str | None
    minimum: float | None = None
    parse: object = None
    tunable: Tunable | None = None
    why_not: str = ""  # for target=None: why the port has no counterpart
    # JAX's kill-switch contract (analysis rules GL301 / GL302): the test
    # file that pins the argument's off arm against its on arm
    kill_switch: bool = False
    pinned_by: str | None = None

    def parse_raw(self, raw: str):
        """JAX's ``Flag.parse_raw``: the kind's parser (or ``parse``), then
        the ``minimum`` clamp."""
        if self.kind == "bool":
            return raw.strip().lower() in _TRUTHY
        if self.parse is not None:
            return self.parse(raw)
        val = {"int": int, "float": float, "str": str}[self.kind](raw)
        if self.minimum is not None:
            val = max(type(val)(self.minimum), val)
        return val

    def render_default(self) -> str:
        if self.kind == "bool":
            return "1" if self.default else "0"
        if self.kind == "str":
            return str(self.default) if self.default else "0"
        return str(self.default)


_CHOICE01 = Tunable("choice", choices=("0", "1"))
_TILE = "the CUDA kernels choose their own tiles; the Pallas tile flags have no counterpart"


def _k(env, kind, default, target, arg, **kw) -> Knob:
    return Knob("PATHWAY_TPU_" + env, kind, default, target, arg, **kw)


KNOBS: tuple[Knob, ...] = (
    # the 25 flags JAX declares a Tunable for, in its registry's order
    _k("PIPELINE_DEPTH", "int", 2, "SentenceEmbedderModel", "pipeline_depth", minimum=1,
       tunable=Tunable("int", lo=1, hi=8, log=True)),
    _k("PIPELINE_QUEUE", "int", 8, "SentenceEmbedderModel", "pipeline_queue", minimum=1,
       tunable=Tunable("int", lo=2, hi=32, log=True)),
    _k("CHUNKED_PREFILL", "bool", True, "DecoderChat", "chunked_prefill", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_chunk_admission.py"),
    _k("PREFILL_CHUNK", "int", 64, "DecoderChat", "prefill_chunk", minimum=8,
       tunable=Tunable("int", lo=8, hi=256, log=True)),
    _k("EAGER_REFILL", "bool", True, "DecoderChat", "eager_refill", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_chunk_admission.py"),
    _k("DRAIN_COALESCE_MAX", "int", 8, "EngineConfig", "drain_coalesce_max", minimum=1,
       tunable=Tunable("int", lo=1, hi=32, log=True)),
    _k("BATCH_ADMIT", "bool", True, "DecoderChat", "batch_admit", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_chunk_admission.py"),
    _k("PREFILL_OVERLAP", "bool", True, "DecoderChat", "prefill_overlap", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_chunk_admission.py"),
    _k("CHUNK_AUTOTUNE", "bool", True, "DecoderChat", "chunk_autotune", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_chunk_admission.py"),
    _k("PREFIX_CACHE", "bool", True, "DecoderChat", "prefix_cache", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_prefix_cache.py"),
    _k("PREFIX_CACHE_MB", "float", 64, "DecoderChat", "prefix_cache_mb", minimum=0,
       tunable=Tunable("float", lo=8, hi=256, log=True)),
    _k("PREFIX_BLOCK", "int", 0, "DecoderChat", "prefix_block", minimum=0,
       tunable=Tunable("choice", choices=("0", "8", "16", "32", "64"))),
    _k("SPEC_DECODE", "bool", True, "DecoderChat", "spec_decode", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_spec_decode.py"),
    _k("SPEC_DECODE_DRAFT_LAYERS", "int", 0, "DecoderChat", "spec_draft_layers", minimum=0,
       tunable=Tunable("choice", choices=("0", "1", "2"))),
    _k("SPEC_DECODE_K", "int", 3, "DecoderChat", "spec_k", minimum=1,
       tunable=Tunable("int", lo=1, hi=8, step=1)),
    _k("WEIGHT_QUANT", "str", "", "DecoderChat", "weight_quant", parse=_parse_int8,
       tunable=Tunable("choice", choices=("0", "int8")),
       kill_switch=True, pinned_by="tests/test_torch_serving.py"),
    _k("FLASH_PREFILL", "bool", False, "DecoderChat", "flash_prefill", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_prefix_cache.py"),
    _k("FLASH_BLOCK_Q", "int", 0, None, None, minimum=0, why_not=_TILE,
       tunable=Tunable("choice", choices=("0", "64", "128", "256", "512"))),
    _k("FLASH_BLOCK_K", "int", 0, None, None, minimum=0, why_not=_TILE,
       tunable=Tunable("choice", choices=("0", "64", "128", "256", "512"))),
    _k("DISAGG", "bool", False, "DecoderChat", "disagg", tunable=_CHOICE01,
       kill_switch=True, pinned_by="tests/test_torch_disagg.py"),
    _k("DISAGG_PREFILL_BUDGET", "int", 1, "DecoderChat", "disagg_prefill_budget", minimum=1,
       tunable=Tunable("int", lo=1, hi=4, step=1)),
    _k("PREFIX_T2_MB", "float", 0.0, "DecoderChat", "prefix_t2_mb", minimum=0,
       tunable=Tunable("choice", choices=("0", "16", "64"))),
    _k("QUERY_TICK_MS", "float", 2.0, "QueryServer", "tick_ms", minimum=0,
       tunable=Tunable("float", lo=0.5, hi=8, log=True)),
    _k("QUERY_MAX_BATCH", "int", 64, "QueryServer", "max_batch", minimum=1,
       tunable=Tunable("int", lo=8, hi=128, log=True)),
    _k("TENANT_BUDGET", "int", 0, "DecoderChat", "tenant_budget", minimum=0,
       tunable=Tunable("choice", choices=("0", "64", "128", "256"))),
    # the flags profiles, validation and the chip phase set
    _k("TENANT_SCHED", "bool", False, "DecoderChat", "tenant_sched",
       kill_switch=True, pinned_by="tests/test_torch_disagg.py"),
    _k("TENANT_WEIGHTS", "str", "", "DecoderChat", "tenant_weights"),
    _k("SLO_E2E_P95_MS", "float", 0.0, "slo", "e2e_p95_ms"),
    _k("CHAOS", "float", 0.0, "chaos", "rate", minimum=0,
       kill_switch=True, pinned_by="tests/test_torch_chaos.py"),
    _k("CHAOS_SITES", "str", "", "chaos", "sites"),
    _k("CHAOS_SEED", "int", 0, "chaos", "seed"),
    _k("SERVE_RESTARTS", "int", 0, "DecoderChat", "serve_restarts", minimum=0,
       kill_switch=True, pinned_by="tests/test_torch_supervision.py"),
    _k("SERVE_RETRIES", "int", 1, "DecoderChat", "serve_retries", minimum=0),
    _k("PAGED_KV", "bool", False, "DecoderChat", "paged_kv",
       kill_switch=True, pinned_by="tests/test_torch_serving.py"),
    _k("PAGED_KERNEL", "bool", False, "DecoderChat", "paged_kernel",
       kill_switch=True, pinned_by="tests/test_torch_serving.py"),
    _k("WQ_KERNEL", "bool", False, "DecoderChat", "wq_kernel",
       kill_switch=True, pinned_by="tests/test_torch_serving.py"),
)

KNOBS_BY_ENV: dict[str, Knob] = {k.env: k for k in KNOBS}


class TunedConfigError(ValueError):
    """A tuned-config artifact that cannot be loaded: a missing file, bad
    JSON, or an unknown, refused or unparseable flag. Loud on purpose, as
    in JAX: a silently dropped artifact would pass for a slowdown."""


def _raw(val) -> str:
    return ("1" if val else "0") if isinstance(val, bool) else str(val)


def load_tuned_config(path: str) -> dict[str, str]:
    """Parse one artifact into ``{env: raw}`` with JAX's checks: a JSON
    object with a ``flags`` mapping, every key a knob of the table (the
    artifact's own flag, ``PATHWAY_TPU_TUNED_CONFIG``, refused) whose
    value survives the knob's parser. A knob without a counterpart in the
    port (the Pallas tile sizes) is refused by name."""
    import json

    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as exc:
        raise TunedConfigError(f"tuned config {path!r}: {exc}") from exc
    if not isinstance(data, dict) or not isinstance(data.get("flags"), dict):
        raise TunedConfigError(
            f"tuned config {path!r}: expected a JSON object with a 'flags' mapping")
    out: dict[str, str] = {}
    for env in sorted(data["flags"]):
        knob = KNOBS_BY_ENV.get(env)
        if knob is None:
            raise TunedConfigError(
                f"tuned config {path!r}: {env!r} is not a tunable registry flag")
        if knob.target is None:
            raise TunedConfigError(
                f"tuned config {path!r}: {env} has no counterpart in "
                f"pathway_tpu_torch ({knob.why_not})")
        raw = _raw(data["flags"][env])
        try:
            knob.parse_raw(raw)
        except (TypeError, ValueError) as exc:
            raise TunedConfigError(
                f"tuned config {path!r}: {env}={raw!r} does not parse: {exc}") from exc
        out[env] = raw
    return out


def knob_arguments(flags: dict) -> dict[str, dict]:
    """``{env: raw}`` (raw strings, or bools as JAX's overrides take them)
    as ``{target: {argument: parsed value}}``. An unknown flag raises
    ``KeyError`` and a knob without a counterpart ``TunedConfigError``."""
    out: dict[str, dict] = {}
    for env, val in flags.items():
        knob = KNOBS_BY_ENV.get(env)
        if knob is None:
            raise KeyError(f"{env!r} is not a knob of the port's table")
        if knob.target is None:
            raise TunedConfigError(f"{env} has no counterpart in pathway_tpu_torch "
                                   f"({knob.why_not})")
        out.setdefault(knob.target, {})[knob.arg] = knob.parse_raw(_raw(val))
    return out


# the artifacts constructors loaded in this process, in load order:
# path -> {"flags": {env: raw}, "shadowed_by_args": {env, ...}}
_LOADED: dict[str, dict] = {}


def apply_tuned_config(path: str | None, target: str, passed: dict) -> dict:
    """``passed`` (a constructor's knob arguments, ``None`` where the
    caller passed nothing) with the values of the artifact at ``path``
    filled in where ``passed`` holds ``None``. Records the artifact, and
    the flags an explicit argument out-ranked, for
    :func:`tuned_config_snapshot`. ``path=None`` returns ``passed``."""
    if path is None:
        return dict(passed)
    path = str(path)
    flags = load_tuned_config(path)
    entry = _LOADED.setdefault(path, {"flags": {}, "shadowed_by_args": set()})
    entry["flags"] = dict(flags)
    out = dict(passed)
    for env, raw in flags.items():
        knob = KNOBS_BY_ENV[env]
        if knob.target != target or knob.arg not in out:
            continue
        if out[knob.arg] is None:
            out[knob.arg] = knob.parse_raw(raw)
        else:
            entry["shadowed_by_args"].add(env)
    return out


def tuned_config_snapshot() -> dict:
    """The ``tuning`` section of ``probes.unified_snapshot()``: the
    artifacts constructors loaded in this process (``path`` the latest),
    the flags they pin (a later artifact's value wins), and
    ``shadowed_by_args``, the flags an explicit argument out-ranked (JAX
    lists ``shadowed_by_env``: the port reads no environment)."""
    if not _LOADED:
        return {"enabled": False, "path": None, "paths": [], "flags": {},
                "shadowed_by_args": []}
    flags: dict[str, str] = {}
    shadowed: set = set()
    for entry in _LOADED.values():
        flags.update(entry["flags"])
        shadowed |= entry["shadowed_by_args"]
    return {"enabled": True, "path": list(_LOADED)[-1], "paths": list(_LOADED),
            "flags": flags, "shadowed_by_args": sorted(shadowed)}


def clear_tuned_configs() -> None:
    """Forget the artifacts loaded so far (tests, between arms)."""
    _LOADED.clear()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # PATHWAY_FUSION: stateless operator-chain fusion (graph.fuse_chains)
    fusion: bool = True
    # PATHWAY_TPU_COLUMNAR_SUBSCRIBE: subscribe callbacks formatted on a
    # background thread, one columnar block an epoch
    columnar_subscribe: bool = True
    # PATHWAY_TPU_DRAIN_COALESCE(_MAX): the deferred-UDF drainer merges
    # resolved chunks into one injected batch while the engine is behind
    drain_coalesce: bool = True
    drain_coalesce_max: int | None = None  # None: the tuned config's, else 8
    # PATHWAY_TPU_EPOCH_CLOSEOUT: consolidation proofs ride column
    # transforms, and the end-of-epoch sweep visits only nodes with an
    # on_time_end
    epoch_closeout: bool = True
    # PATHWAY_TPU_OP_METRICS: per-operator registry telemetry
    op_metrics: bool = True
    # PATHWAY_TERMINATE_ON_ERROR: an ERROR value reaching an output aborts
    terminate_on_error: bool = True
    # PATHWAY_THREADS: operators of one topological level step in a pool
    threads: int = 1
    # PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_FIRST_PORT: the
    # run is one of ``processes`` processes on this host, which exchange
    # rows over a TCP mesh; process ``p`` listens on ``first_port + p``
    # (engine/exchange.py). A launcher's child builds these from its own
    # variables: the port reads none.
    processes: int = 1
    process_id: int = 0
    first_port: int = 10000
    # the metrics server of pw.run(with_http_server=True) listens on
    # metrics_first_port + process_id (JAX's fixed 20000 + process id);
    # 0 binds an ephemeral port, read back from run.METRICS_SERVER.port
    metrics_first_port: int = 20000
    # a tuned-config artifact (``python -m pathway_tpu_torch tune``): fills
    # the tunable fields left at None (drain_coalesce_max)
    tuned_config: str | None = None

    def __post_init__(self):
        knobs = apply_tuned_config(self.tuned_config, "EngineConfig",
                                   {"drain_coalesce_max": self.drain_coalesce_max})
        if knobs["drain_coalesce_max"] is None:
            knobs["drain_coalesce_max"] = 8
        object.__setattr__(self, "drain_coalesce_max", int(knobs["drain_coalesce_max"]))
        if self.drain_coalesce_max < 1:
            raise ValueError("drain_coalesce_max must be at least 1")
        if self.threads < 1:
            raise ValueError("threads must be at least 1")
        if self.processes < 1:
            raise ValueError("processes must be at least 1")
        if not 0 <= self.process_id < self.processes:
            raise ValueError(
                f"process_id must be in [0, {self.processes}), got {self.process_id}")
        if not 0 < self.first_port <= 65536 - self.processes:
            raise ValueError(f"first_port {self.first_port} leaves no room for "
                             f"{self.processes} ports")


_active = EngineConfig()


def active() -> EngineConfig:
    return _active


def install(config: EngineConfig) -> EngineConfig:
    """Make ``config`` the active one; returns the one it replaced."""
    global _active
    prev, _active = _active, config
    return prev


# the persistence Config of the run in progress (pw.run(persistence_config=
# ...)), read while it runs by what JAX reads get_persistence_config() for
# (the UDF caches); None outside a run or for a run without one. JAX builds
# its default from the PATHWAY_REPLAY_STORAGE family of variables; the port
# reads none: the CLI's ``replay`` passes its Config to the program's runs
_persistence = None


def persistence():
    return _persistence


def install_persistence(cfg):
    """Make ``cfg`` the running persistence Config; returns the one it
    replaced."""
    global _persistence
    prev, _persistence = _persistence, cfg
    return prev


# --------------------------------------------------------------------- #
# the environment's choke points (JAX's names): the library reads no flag,
# and the few legitimate environment reads go through these three
# functions, so that "who reads the environment" stays a one-file question
# (analysis rules GL201 / GL202)

# the spawn contract a launcher hands the processes it starts (``cli
# spawn``, ``serving.spawn_replica_process``): read only by code a caller
# runs to join such a launch, ``DistributedConfig.from_env`` and the CLI's
# ``spawn-from-env``
LAUNCHER_VARS = (
    "PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_FIRST_PORT",
    "PATHWAY_COORDINATOR", "PATHWAY_SPAWN_ARGS",
)


def env_interpolate(name: str) -> str | None:
    """Read one environment variable by (possibly dynamic) name: a
    variable the user names (YAML ``$ENV`` interpolation) or a toolchain's
    (``CUDA_HOME``), never a setting of the library."""
    return os.environ.get(name)


def environ_snapshot(**overrides: str) -> dict[str, str]:
    """A copy of the current process environment (plus ``overrides``),
    for handing a subprocess its inherited environment."""
    env = dict(os.environ)
    env.update(overrides)
    return env


def launcher_env(name: str) -> str | None:
    """One variable of a launcher's spawn contract (``LAUNCHER_VARS``)."""
    if name not in LAUNCHER_VARS:
        raise KeyError(f"{name} is not a variable of the spawn contract")
    return os.environ.get(name)


# PATHWAY_LICENSE_KEY / PATHWAY_MONITORING_SERVER: kept for what reads
# them (the OpenTelemetry exporter, ROADMAP A12); set through the two
# functions below, as in JAX, never read from the environment
license_key: str | None = None
monitoring_server: str | None = None


def set_license_key(key: str | None) -> None:
    global license_key
    license_key = key


def set_monitoring_config(*, server_endpoint: str | None) -> None:
    global monitoring_server
    monitoring_server = server_endpoint

