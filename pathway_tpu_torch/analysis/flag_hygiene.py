"""GL2xx — flag-hygiene pass (counterpart of
``pathway_tpu/analysis/flag_hygiene.py``, retargeted at the port).

JAX declares every knob once in ``FLAG_REGISTRY`` and reads it through
``pathway_config``. The port reads no flag: each JAX knob is a
constructor argument, an ``EngineConfig`` field or a module setting
(``chaos.configure``, ``slo.configure``), and ``internals/config.py``'s
``KNOBS`` table maps each tunable JAX flag to the argument that stands
for it. The rules keep JAX's ids:

* **GL201** — a *literal* ``PATHWAY*`` env read anywhere outside
  ``internals/config.py`` (``os.environ["PATHWAY_X"]``,
  ``os.environ.get(...)``, ``os.getenv(...)``, including
  ``from os import environ`` aliases): the knob bypasses the port's
  arguments. A launcher's spawn contract is read through
  ``config.launcher_env``.
* **GL202** — any *other* ``os.environ`` / ``os.getenv`` use outside
  ``internals/config.py`` (dynamic keys, ``in os.environ`` membership,
  whole-environment copies for subprocesses). These go through the
  audited choke points ``config.env_interpolate`` /
  ``config.environ_snapshot`` instead, so "who reads the environment"
  stays a one-file question.
* **GL203** — a ``KNOBS`` entry whose argument no constructor takes: the
  constructor (or ``configure``) of its ``target`` has no parameter or
  dataclass field named ``arg``. A tuned config would then set nothing.
  (JAX's GL203 looks for a flag nobody reads; in the port a knob is read
  by being an argument, so the check is that the argument exists.)
* **GL204** — a knob carrying a ``Tunable`` search spec whose space is
  broken: missing/non-finite bounds, an inverted range, a non-positive
  step, an empty or single-rung candidate ladder, or a default outside
  the declared space.

GL203/GL204 are registry-wide, so they only fire on full-package runs
(they need ``internals/config.py`` in the scanned set); unit tests
exercise :func:`check_dead_knobs` / :func:`check_tunable_bounds`
directly with synthetic tables.
"""

from __future__ import annotations

import ast

from pathway_tpu_torch.analysis.core import Finding, ModuleSource, PackageCtx

CONFIG_PATH = "pathway_tpu_torch/internals/config.py"

# a knob's ``target`` -> (module, class or function whose parameters are
# the arguments that target takes)
KNOB_TARGETS = {
    "DecoderChat": ("pathway_tpu_torch/xpacks/llm/llms.py", "DecoderChat"),
    "SentenceEmbedderModel": ("pathway_tpu_torch/models/embedder.py",
                              "SentenceEmbedderModel"),
    "QueryServer": ("pathway_tpu_torch/ops/query_server.py", "QueryServer"),
    "EngineConfig": (CONFIG_PATH, "EngineConfig"),
    "chaos": ("pathway_tpu_torch/engine/chaos.py", "configure"),
    "slo": ("pathway_tpu_torch/engine/slo.py", "configure"),
}


def _env_aliases(src: ModuleSource) -> tuple[set[str], set[str], set[str]]:
    """(os-module aliases, `environ` aliases, `getenv` aliases)."""
    os_names: set[str] = set()
    environ_names: set[str] = set()
    getenv_names: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "os":
                    os_names.add(a.asname or "os")
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "environ":
                    environ_names.add(a.asname or "environ")
                elif a.name == "getenv":
                    getenv_names.add(a.asname or "getenv")
    return os_names, environ_names, getenv_names


def _literal_pathway_key(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value.startswith("PATHWAY"):
            return node.value
    return None


def run(ctx: PackageCtx) -> list[Finding]:
    findings: list[Finding] = []
    for src in ctx.modules:
        if src.path == CONFIG_PATH:
            continue
        _check_module(findings, src)

    config = ctx.module(CONFIG_PATH)
    if config is not None and ctx.registry_checks:
        findings.extend(_dead_flags_on_repo(ctx, config))
        findings.extend(_tunable_bounds_on_repo(config))
    return findings


def _check_module(out: list[Finding], src: ModuleSource) -> None:
    os_names, environ_names, getenv_names = _env_aliases(src)
    if not (os_names or environ_names or getenv_names):
        return

    def is_environ(node: ast.AST) -> bool:
        if (
            isinstance(node, ast.Attribute)
            and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id in os_names
        ):
            return True
        return isinstance(node, ast.Name) and node.id in environ_names

    def is_getenv(node: ast.AST) -> bool:
        if (
            isinstance(node, ast.Attribute)
            and node.attr == "getenv"
            and isinstance(node.value, ast.Name)
            and node.value.id in os_names
        ):
            return True
        return isinstance(node, ast.Name) and node.id in getenv_names

    flagged: set[int] = set()  # id() of environ nodes already reported

    def emit(rule: str, node: ast.AST, detail: str) -> None:
        src.emit(out, rule, node, detail)

    for node in ast.walk(src.tree):
        # os.environ[KEY] / environ.get(KEY) / os.getenv(KEY)
        if isinstance(node, ast.Subscript) and is_environ(node.value):
            flagged.add(id(node.value))
            key = _literal_pathway_key(node.slice)
            if key:
                emit("GL201", node,
                     f"literal env read `{key}` outside internals/config.py "
                     "— make the knob an argument")
            else:
                emit("GL202", node,
                     "dynamic `os.environ[...]` outside internals/config.py "
                     "— use `config.env_interpolate`")
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in ("get", "setdefault", "pop")
                and is_environ(f.value)
            ):
                flagged.add(id(f.value))
                key = node.args and _literal_pathway_key(node.args[0]) or None
                if key:
                    emit("GL201", node,
                         f"literal env read `{key}` outside "
                         "internals/config.py — make the knob an argument")
                else:
                    emit("GL202", node,
                         f"`os.environ.{f.attr}(...)` outside "
                         "internals/config.py — use `config.env_interpolate`")
            elif is_getenv(f):
                key = node.args and _literal_pathway_key(node.args[0]) or None
                if key:
                    emit("GL201", node,
                         f"literal env read `{key}` outside "
                         "internals/config.py — make the knob an argument")
                else:
                    emit("GL202", node,
                         "`os.getenv(...)` outside internals/config.py — "
                         "use `config.env_interpolate`")

    # bare os.environ touches not covered above (copies, membership,
    # iteration, passing the mapping around)
    for node in ast.walk(src.tree):
        if is_environ(node) and id(node) not in flagged:
            # skip the inner `os.environ` of already-flagged parents:
            # only Attribute/Name nodes reach here
            emit("GL202", node,
                 "`os.environ` used outside internals/config.py — use "
                 "`config.environ_snapshot` / `config.env_interpolate`")


# --------------------------------------------------------------------- #
# GL203 dead knobs


def check_dead_knobs(knobs, params) -> list[tuple[str, str | None]]:
    """Knobs whose argument no constructor takes. ``knobs`` is an
    iterable with ``.env`` / ``.target`` / ``.arg`` (``target=None``:
    the port has no counterpart, exempt); ``params`` maps a target to
    the set of argument names it takes (absent: the target was not
    found). Returns ``[(env, arg), ...]``."""
    dead: list[tuple[str, str | None]] = []
    for knob in knobs:
        target = getattr(knob, "target", None)
        if target is None:
            continue
        if knob.arg not in params.get(target, ()):
            dead.append((knob.env, knob.arg))
    return dead


def _registry_line(config: ModuleSource, env: str) -> int:
    # KNOBS entries spell the flag without its PATHWAY_TPU_ prefix
    short = env.removeprefix("PATHWAY_TPU_")
    for needle in (f'"{env}"', f'"{short}"'):
        for i, line in enumerate(config.lines, start=1):
            if needle in line:
                return i
    return 1


def _params_of(node: ast.AST) -> set[str]:
    """Argument names of a function, or of a class's ``__init__`` plus
    its annotated fields (a dataclass)."""
    def fn_params(fn) -> set[str]:
        a = fn.args
        return {x.arg for x in (list(a.posonlyargs) + list(a.args)
                                + list(a.kwonlyargs))} - {"self"}

    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn_params(node)
    out: set[str] = set()
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            out |= fn_params(item)
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            out.add(item.target.id)
    return out


def target_params(ctx: PackageCtx) -> dict[str, set[str]]:
    """``KNOB_TARGETS`` resolved over the scanned sources."""
    out: dict[str, set[str]] = {}
    for target, (path, name) in KNOB_TARGETS.items():
        src = ctx.module(path)
        if src is None:
            continue
        for node in src.tree.body:
            if (isinstance(node, (ast.ClassDef, ast.FunctionDef))
                    and node.name == name):
                out[target] = _params_of(node)
    return out


def _dead_flags_on_repo(
    ctx: PackageCtx, config: ModuleSource
) -> list[Finding]:
    from pathway_tpu_torch.internals.config import KNOBS

    findings: list[Finding] = []
    for env, arg in check_dead_knobs(KNOBS, target_params(ctx)):
        line = _registry_line(config, env)
        node = ast.Constant(value=env)
        node.lineno = line
        config.emit(
            findings, "GL203", node,
            f"knob `{env}` names argument `{arg}`, which its target's "
            "constructor does not take — fix the table or the constructor",
            env,
        )
    return findings


# --------------------------------------------------------------------- #
# GL204 tunable bounds


def check_tunable_bounds(flags) -> list[tuple[str, str]]:
    """Malformed ``Tunable`` search specs. ``flags`` is an iterable with
    ``.env`` / ``.tunable`` (``None`` = not tunable; ``KNOBS`` entries
    or synthetic ones) where a spec has
    ``.kind`` / ``.lo`` / ``.hi`` / ``.step`` / ``.log`` / ``.choices``
    / ``.candidates()``, and the flag parses raw values via
    ``.parse_raw`` and renders its default via ``.render_default``.
    Returns ``[(env, problem), ...]``."""
    import math

    bad: list[tuple[str, str]] = []
    for flag in flags:
        spec = getattr(flag, "tunable", None)
        if spec is None:
            continue
        env = flag.env

        def problem(msg: str, env=env) -> None:
            bad.append((env, msg))

        if spec.kind == "choice":
            if len(spec.choices) < 2:
                problem("choice spec needs >= 2 choices")
                continue
        elif spec.kind in ("int", "float"):
            if spec.lo is None or spec.hi is None:
                problem(f"{spec.kind} spec must declare lo and hi")
                continue
            lo, hi = float(spec.lo), float(spec.hi)
            if not (math.isfinite(lo) and math.isfinite(hi)):
                problem("bounds must be finite")
                continue
            if lo >= hi:
                problem(f"inverted/empty range [{lo}, {hi}]")
                continue
            if spec.log:
                if lo <= 0:
                    problem("log ladder needs lo > 0")
                    continue
            elif spec.step is not None and float(spec.step) <= 0:
                problem(f"non-positive step {spec.step}")
                continue
        else:
            problem(f"unknown tunable kind {spec.kind!r}")
            continue

        try:
            cands = spec.candidates()
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            problem(f"candidates() raised {type(exc).__name__}: {exc}")
            continue
        if len(cands) < 2:
            problem(f"degenerate candidate ladder ({len(cands)} rung)")
            continue
        # every rung must round-trip through the flag's own parser
        try:
            parsed = [flag.parse_raw(c) for c in cands]
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            problem(f"candidate fails flag parser: {exc}")
            continue
        # the default must live inside the declared space (compare in
        # parsed units: choice "0" on a float flag means 0.0)
        default = flag.parse_raw(flag.render_default())
        if spec.kind == "choice":
            if default not in parsed:
                problem(
                    f"default {default!r} is not one of the choices"
                )
        else:
            lo, hi = float(spec.lo), float(spec.hi)
            try:
                dv = float(default)
            except (TypeError, ValueError):
                problem(
                    f"non-numeric default {default!r} on a {spec.kind} range"
                )
                continue
            if not (lo <= dv <= hi):
                problem(f"default {dv} outside [{lo}, {hi}]")
    return bad


def _tunable_bounds_on_repo(config: ModuleSource) -> list[Finding]:
    from pathway_tpu_torch.internals.config import KNOBS

    findings: list[Finding] = []
    for env, msg in check_tunable_bounds(KNOBS):
        node = ast.Constant(value=env)
        node.lineno = _registry_line(config, env)
        config.emit(
            findings, "GL204", node,
            f"knob `{env}` has a malformed tunable spec: {msg}",
            env,
        )
    return findings
