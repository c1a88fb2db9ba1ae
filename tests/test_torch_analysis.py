"""graft-lint over the port (``pathway_tpu_torch/analysis/``) against the
JAX package's (``tests/test_static_analysis.py`` is the bar).

* GL1xx, retargeted at the port's launch boundary (functions that reach
  ``kernels.launch``): one violating and one clean snippet per rule.
* GL2xx / GL3xx, retargeted at ``KNOBS``: JAX's synthetic cases through the
  injectable checkers, and the live table.
* GL4xx and the core (fingerprints, pragmas, baseline): both packages'
  passes on the same source text give equal findings, fingerprints
  included; the same for every port module that declares a guard.
* The gates: the whole port scans clean against an empty baseline, the
  README rule table is generated output, the CLI exits 0 on the port and
  1 on each rule's violation.
* The runtime sanitizer: JAX's cases on the port's ``runtime``, the port's
  registry, query server and a continuous ``DecoderChat`` burst on the CPU
  (zero reports; streams equal to the sanitizer-off arm).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from pathway_tpu.analysis import core as jcore
from pathway_tpu.analysis import lock_discipline as jlock
from pathway_tpu_torch.analysis import __main__ as cli
from pathway_tpu_torch.analysis import core
from pathway_tpu_torch.analysis import lock_discipline as tlock
from pathway_tpu_torch.analysis import runtime as rt
from pathway_tpu_torch.analysis.annotations import guarded_by
from pathway_tpu_torch.analysis.core import Finding, analyze_source
from pathway_tpu_torch.analysis.flag_hygiene import (
    check_dead_knobs,
    check_tunable_bounds,
    target_params,
)
from pathway_tpu_torch.analysis.kill_switch import (
    check_kill_switches,
    check_pinning_refs,
)
from pathway_tpu_torch.internals import config as C

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = types.SimpleNamespace


def _rules(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------------ GL101

LAUNCH_HEAD = """
import time
from pathway_tpu_torch import kernels
"""


def test_gl101_host_effect_flagged():
    src = LAUNCH_HEAD + """
def wrapper(x):
    t = time.perf_counter()
    print(x)
    kernels.launch("k", "f", x.data_ptr())
    return t
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL101"]
    msgs = [f.message for f in found]
    assert any("time.perf_counter" in m for m in msgs)
    assert any("print" in m for m in msgs)


def test_gl101_reaches_through_call_graph():
    """The helper does not launch; a launching function calls it."""
    src = LAUNCH_HEAD + """
def helper(x):
    print(x)
    return x

def wrapper(x):
    kernels.launch("k", "f", helper(x).data_ptr())
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL101"]
    assert found[0].symbol == "helper"


def test_gl101_same_module_caller_is_a_root():
    """A function that calls a launching function in its own module is on
    the path (flash_chunk_attn -> _launch_chunk): its effects count."""
    src = LAUNCH_HEAD + """
def _launch(x):
    kernels.launch("k", "f", x.data_ptr())

def public(x):
    time.sleep(0)
    return _launch(x)
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL101"]
    assert found[0].symbol == "public"


def test_gl101_function_level_import_and_from_import_launch():
    src = """
def a(x):
    from pathway_tpu_torch import kernels
    print(x)
    kernels.launch("k", "f", x.data_ptr())
"""
    assert [f.symbol for f in analyze_source(src)] == ["a"]
    src = """
from pathway_tpu_torch.kernels import launch

def b(x):
    print(x)
    launch("k", "f", x.data_ptr())
"""
    assert [f.symbol for f in analyze_source(src)] == ["b"]


def test_gl101_config_and_observability_calls():
    src = LAUNCH_HEAD + """
from pathway_tpu_torch.engine import probes
from pathway_tpu_torch.internals import config

def wrapper(x):
    cfg = config.active()
    probes.counter_add("launches")
    kernels.launch("k", "f", x.data_ptr(), cfg.threads)
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL101"]
    msgs = " ".join(f.message for f in found)
    assert "config read" in msgs and "observability call" in msgs


def test_gl101_clean_wrapper():
    src = """
import math
import torch
from pathway_tpu_torch import kernels

def _plan(n):
    return max(1, n // 64)

def wrapper(x, sm_scale=None):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(x.shape[-1])
    out = torch.empty_like(x)
    kernels.launch("k", "f", x.data_ptr(), out.data_ptr(), _plan(x.shape[0]),
                   float(sm_scale))
    return out
"""
    assert analyze_source(src) == []


def test_gl101_effect_off_the_launch_path_is_fine():
    src = """
import time

def host_side():
    return time.perf_counter()
"""
    assert analyze_source(src) == []


def test_gl101_the_boundary_itself_is_not_walked():
    """kernels.py's own machinery (the one-time build, the library cache)
    is the boundary, not the path."""
    kernels_src = """
import os
import subprocess

def build(name):
    print("building", name)
    return os.environ.get("CUDA_HOME")

def launch(name, fn, *args):
    build(name)
"""
    wrapper_src = LAUNCH_HEAD + """
def wrapper(x):
    kernels.launch("k", "f", x.data_ptr())
"""
    ctx = core.PackageCtx(repo_root=REPO_ROOT, modules=[
        core.ModuleSource("pathway_tpu_torch/kernels.py", kernels_src),
        core.ModuleSource("pathway_tpu_torch/models/w.py", wrapper_src),
    ], registry_checks=False)
    from pathway_tpu_torch.analysis import jit_purity

    assert jit_purity.run(ctx) == []


# ------------------------------------------------------------------ GL102


@pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.tolist()",
                                  "x.numpy()", "np.sum(x)"])
def test_gl102_host_sync_on_a_parameter(call):
    src = LAUNCH_HEAD + f"""
import numpy as np

def wrapper(x):
    n = {call}
    kernels.launch("k", "f", x.data_ptr(), n)
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL102"]
    assert "reaches kernels.launch" in found[0].message


def test_gl102_host_values_are_fine():
    """np on a host value, and .item() of a local, are not the parameter."""
    src = LAUNCH_HEAD + """
import numpy as np

def wrapper(x, n):
    pad = np.zeros(4)
    kernels.launch("k", "f", x.data_ptr(), int(n), len(pad))
"""
    assert analyze_source(src) == []


# ------------------------------------------------------------------ GL103


def test_gl103_mutated_mutable_read_on_the_path():
    src = LAUNCH_HEAD + """
_PLANS = {}

def warm(k, v):
    _PLANS[k] = v

def wrapper(x):
    kernels.launch("k", "f", x.data_ptr(), len(_PLANS))
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL103"]
    assert "_PLANS" in found[0].message


def test_gl103_constant_table_and_guarded_mutable_are_fine():
    src = LAUNCH_HEAD + """
import threading

_GUARDED_BY = {"_PLANS": "_plans_lock"}
_plans_lock = threading.Lock()
_PLANS = {}
_TABLE = [1, 2, 3]

def warm(k, v):
    with _plans_lock:
        _PLANS[k] = v

def wrapper(x):
    with _plans_lock:
        n = len(_PLANS)
    kernels.launch("k", "f", x.data_ptr(), n + len(_TABLE))
"""
    assert analyze_source(src) == []


def test_launch_roots_of_the_port_are_the_kernel_wrappers():
    from pathway_tpu_torch.analysis import jit_purity as jp

    ctx = core.collect_package(REPO_ROOT)
    sources = {jp._module_name(m.path): m for m in ctx.modules}
    imports = {m: jp._Imports(s) for m, s in sources.items()}
    by_name = {m: {n.name: jp._FuncRef(s, n) for n in s.tree.body
                   if isinstance(n, jp.ast.FunctionDef)} for m, s in sources.items()}
    roots = {(jp._module_name(r.src.path).rsplit(".", 1)[1], r.node.name)
             for r in jp._collect_roots(by_name, imports)}
    assert roots == {
        ("flash_attention", "flash_attn"), ("flash_attention", "_launch_chunk"),
        ("flash_attention", "flash_chunk_attn"),
        ("flash_attention", "flash_chunk_attn_paged"),
        ("paged_attention", "paged_attn_decode"), ("paged_attention", "_launch"),
        ("wq_matmul", "wq_matmul"),
    }


# ------------------------------------------------------------------ GL201


def test_gl201_literal_env_read():
    src = """
import os

def mode():
    a = os.environ.get("PATHWAY_TPU_MODE", "0")
    b = os.getenv("PATHWAY_TPU_OTHER")
    c = os.environ["PATHWAY_LICENSE_KEY"]
    return a, b, c
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL201"]
    assert len(found) == 3


def test_gl201_config_module_exempt():
    src = """
import os

def read():
    return os.environ.get("PATHWAY_TPU_MODE")
"""
    assert analyze_source(src, path="pathway_tpu_torch/internals/config.py") == []


def test_gl201_pragma_suppresses():
    src = """
import os

def mode():
    return os.environ.get("PATHWAY_TPU_MODE")  # graft-lint: allow[GL201] legacy shim
"""
    assert analyze_source(src) == []


def test_gl201_config_read_is_fine():
    src = """
from pathway_tpu_torch.internals import config

def mode():
    return config.active().threads
"""
    assert analyze_source(src) == []


# ------------------------------------------------------------------ GL202


def test_gl202_dynamic_and_bare_environ():
    src = """
import os

def snap():
    return dict(os.environ)

def read(name):
    return os.getenv(name)
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL202"]
    assert len(found) == 2


def test_gl202_choke_points_are_fine():
    src = """
from pathway_tpu_torch.internals.config import (
    env_interpolate, environ_snapshot, launcher_env,
)

def snap():
    return environ_snapshot(EXTRA="1")

def read(name):
    return env_interpolate(name), launcher_env("PATHWAY_PROCESSES")
"""
    assert analyze_source(src) == []


def test_gl202_aliased_import_caught():
    src = """
from os import environ as E

def snap():
    return "HOME" in E
"""
    found = analyze_source(src)
    assert _rules(found) == ["GL202"]


def test_env_choke_points(monkeypatch):
    """The three sanctioned environment accessors (JAX's two plus the
    launcher's contract), as ``tests/test_flag_registry.py`` pins JAX's."""
    monkeypatch.setenv("PW_TORCH_CHOKE_PROBE", "abc")
    assert C.env_interpolate("PW_TORCH_CHOKE_PROBE") == "abc"
    assert C.env_interpolate("PW_TORCH_CHOKE_ABSENT") is None
    snap = C.environ_snapshot(PW_TORCH_CHOKE_PROBE="xyz")
    assert snap["PW_TORCH_CHOKE_PROBE"] == "xyz"
    monkeypatch.setenv("PATHWAY_PROCESSES", "3")
    assert C.launcher_env("PATHWAY_PROCESSES") == "3"
    with pytest.raises(KeyError):
        C.launcher_env("PATHWAY_TPU_METRICS")


def test_distributed_from_env_reads_the_launcher_contract(monkeypatch):
    """The GL201 repair: from_env reads the spawn contract through
    config.launcher_env, with the values it read before."""
    from pathway_tpu_torch.parallel.distributed import DistributedConfig

    for k in C.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert DistributedConfig.from_env() == DistributedConfig(1, 0, None)
    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "12000")
    assert DistributedConfig.from_env() == DistributedConfig(2, 1, "127.0.0.1:12000")
    monkeypatch.setenv("PATHWAY_COORDINATOR", "h:1")
    assert DistributedConfig.from_env().coordinator_address == "h:1"


def test_replica_and_airbyte_environments_come_from_the_snapshot(monkeypatch):
    """The GL202 repairs hand a child the same environment as before."""
    from pathway_tpu_torch.io import airbyte

    monkeypatch.setenv("PW_TORCH_CHILD_PROBE", "1")
    env = airbyte.environ_snapshot(EXTRA="2")
    assert env["PW_TORCH_CHILD_PROBE"] == "1" and env["EXTRA"] == "2"
    assert env == {**os.environ, "EXTRA": "2"}


# ------------------------------------------------------------------ GL203


def test_gl203_dead_knob_detected():
    knobs = [
        NS(env="PATHWAY_TPU_LIVE", target="DecoderChat", arg="live_knob"),
        NS(env="PATHWAY_TPU_DEAD", target="DecoderChat", arg="dead_knob"),
        NS(env="PATHWAY_TPU_GONE", target="Nowhere", arg="x"),
        NS(env="PATHWAY_TPU_TILE", target=None, arg=None),  # no counterpart
    ]
    params = {"DecoderChat": {"live_knob", "other"}}
    assert check_dead_knobs(knobs, params) == [
        ("PATHWAY_TPU_DEAD", "dead_knob"), ("PATHWAY_TPU_GONE", "x")]


def test_gl203_targets_resolve_constructors_and_dataclass_fields():
    src_cls = """
import dataclasses

class DecoderChat:
    def __init__(self, params=None, *, paged_kv=False, **kw):
        pass

@dataclasses.dataclass
class EngineConfig:
    threads: int = 1
"""
    ctx = core.PackageCtx(repo_root=REPO_ROOT, modules=[
        core.ModuleSource("pathway_tpu_torch/xpacks/llm/llms.py", src_cls),
        core.ModuleSource("pathway_tpu_torch/internals/config.py", src_cls),
    ])
    params = target_params(ctx)
    assert params["DecoderChat"] == {"params", "paged_kv"}
    assert params["EngineConfig"] == {"threads"}


def test_gl203_live_knobs_all_taken():
    ctx = core.collect_package(REPO_ROOT)
    assert check_dead_knobs(C.KNOBS, target_params(ctx)) == []
    assert sum(1 for k in C.KNOBS if k.target is not None) >= 30


# ------------------------------------------------------------------ GL204


def _tknob(env="PATHWAY_TPU_T", default=4, **spec):
    return C.Knob(env, "int" if isinstance(default, int) else "float", default,
                  "DecoderChat", "t", tunable=C.Tunable(**spec))


def test_gl204_healthy_specs_pass():
    knobs = [
        _tknob(kind="int", lo=1, hi=8, log=True),
        _tknob(kind="int", lo=1, hi=8, step=1),
        _tknob(env="PATHWAY_TPU_C", kind="choice", choices=("4", "8")),
        NS(env="PATHWAY_TPU_PLAIN", tunable=None),  # untunable = exempt
    ]
    assert check_tunable_bounds(knobs) == []


@pytest.mark.parametrize("spec,needle", [
    (dict(kind="int", hi=8), "lo and hi"),
    (dict(kind="int", lo=1, hi=float("inf")), "finite"),
    (dict(kind="int", lo=8, hi=1), "inverted"),
    (dict(kind="int", lo=1, hi=8, step=0), "step"),
    (dict(kind="float", lo=0.0, hi=8.0, log=True), "lo > 0"),
    (dict(kind="choice", choices=("4",)), ">= 2 choices"),
    (dict(kind="weird", lo=1, hi=8), "unknown tunable kind"),
])
def test_gl204_malformed_specs_flagged(spec, needle):
    bad = check_tunable_bounds([_tknob(**spec)])
    assert len(bad) == 1 and bad[0][0] == "PATHWAY_TPU_T"
    assert needle in bad[0][1], bad


def test_gl204_default_outside_space_flagged():
    bad = check_tunable_bounds([_tknob(default=32, kind="int", lo=1, hi=8, step=1)])
    assert bad and "outside" in bad[0][1]
    bad = check_tunable_bounds([_tknob(default=3, kind="choice", choices=("4", "8"))])
    assert bad and "not one of the choices" in bad[0][1]


def test_gl204_choice_default_compared_in_parsed_units():
    assert check_tunable_bounds(
        [_tknob(default=0.0, kind="choice", choices=("0", "16"))]) == []


def test_gl204_live_knobs_healthy():
    assert sum(1 for k in C.KNOBS if k.tunable is not None) >= 15
    assert check_tunable_bounds(C.KNOBS) == []
    assert core.RULES["GL204"].name == "tunable-bounds"


# ------------------------------------------------------------------ GL3xx


def test_gl301_pinning_contract(tmp_path):
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    (tests_dir / "test_pin.py").write_text(
        "def test_x():\n    DecoderChat(paged_kv=False)\n")
    knobs = [
        NS(env="PATHWAY_TPU_GOOD", arg="paged_kv", kill_switch=True,
           pinned_by="tests/test_pin.py"),
        NS(env="PATHWAY_TPU_NOPIN", arg="a", kill_switch=True, pinned_by=None),
        NS(env="PATHWAY_TPU_GONE", arg="b", kill_switch=True,
           pinned_by="tests/test_gone.py"),
        NS(env="PATHWAY_TPU_STALE", arg="paged", kill_switch=True,
           pinned_by="tests/test_pin.py"),  # `paged` is only a word part
        NS(env="PATHWAY_TPU_PLAIN", arg="c", kill_switch=False, pinned_by=None),
    ]
    problems = dict(check_kill_switches(knobs, str(tmp_path)))
    assert set(problems) == {"PATHWAY_TPU_NOPIN", "PATHWAY_TPU_GONE",
                             "PATHWAY_TPU_STALE"}
    assert "does not exist" in problems["PATHWAY_TPU_GONE"]
    assert "never references" in problems["PATHWAY_TPU_STALE"]


def test_gl302_prose_only_pin_rejected(tmp_path):
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    (tests_dir / "test_kw.py").write_text(
        "def test_x():\n    make(spec_decode=False)\n")
    (tests_dir / "test_param.py").write_text(
        'import pytest\n@pytest.mark.parametrize("arg", ["disagg"])\n'
        "def test_x(arg):\n    pass\n")
    (tests_dir / "test_prose.py").write_text(
        '"""Pins prefix_cache off byte-identical (it says here)."""\n'
        "# prefix_cache again in a comment\n"
        'def test_x():\n    """Inner: prefix_cache."""\n')
    knobs = [
        NS(env="PATHWAY_TPU_KW", arg="spec_decode", kill_switch=True,
           pinned_by="tests/test_kw.py"),
        NS(env="PATHWAY_TPU_PARAM", arg="disagg", kill_switch=True,
           pinned_by="tests/test_param.py"),
        NS(env="PATHWAY_TPU_PROSE", arg="prefix_cache", kill_switch=True,
           pinned_by="tests/test_prose.py"),
        NS(env="PATHWAY_TPU_GONE", arg="x", kill_switch=True,
           pinned_by="tests/test_missing.py"),
        NS(env="PATHWAY_TPU_NOPIN", arg="y", kill_switch=True, pinned_by=None),
    ]
    problems = dict(check_pinning_refs(knobs, str(tmp_path)))
    assert set(problems) == {"PATHWAY_TPU_PROSE"}
    assert "only in" in problems["PATHWAY_TPU_PROSE"]


def test_gl3xx_live_kill_switches_all_pinned_in_code():
    assert sum(1 for k in C.KNOBS if k.kill_switch) >= 10
    assert check_kill_switches(C.KNOBS, REPO_ROOT) == []
    assert check_pinning_refs(C.KNOBS, REPO_ROOT) == []
    assert "prose" in core.RULES["GL302"].summary


# ----------------------------------------- GL4xx and the core, against JAX

GL4_SOURCES = {
    "unguarded_class_field": """
import threading
from pathway_tpu_torch.analysis.annotations import guarded_by

@guarded_by(items="_lock")
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def bad(self):
        self.items.append(1)

    def good(self):
        with self._lock:
            self.items.append(2)
""",
    "assumes_held": """
import threading
from pathway_tpu_torch.analysis.annotations import assumes_held, guarded_by

@guarded_by(items="_lock")
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    @assumes_held("_lock")
    def _push(self, x):
        self.items.append(x)

    def push(self, x):
        with self._lock:
            self._push(x)
""",
    "nested_closure": """
import threading
from pathway_tpu_torch.analysis.annotations import guarded_by

@guarded_by(items="_lock")
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def sched(self):
        with self._lock:
            def cb():
                self.items.append(1)
            return cb
""",
    "module_global": """
import threading

_GUARDED_BY = {"_ring": "_ring_lock"}

_ring_lock = threading.Lock()
_ring = []

def bad():
    return list(_ring)

def good():
    with _ring_lock:
        return list(_ring)
""",
    "lock_never_assigned": """
from pathway_tpu_torch.analysis.annotations import guarded_by

@guarded_by(items="_lock")
class Box:
    def __init__(self):
        self.items = []
""",
    "module_lock_never_bound": """
_GUARDED_BY = {"_x": "_missing_lock"}

_x = []
""",
    "pragma_on_def": """
import threading
from pathway_tpu_torch.analysis.annotations import guarded_by

@guarded_by(items="_lock")
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def peek(self):  # graft-lint: allow[lock-unguarded-access] racy read is fine
        return len(self.items)

    def poke(self):
        self.items = []  # graft-lint: allow[GL401]
        return self.items  # graft-lint: allow[*]
""",
}
EXPECTED_GL4 = {"unguarded_class_field": ["GL401"], "assumes_held": [],
                "nested_closure": ["GL401"], "module_global": ["GL401"],
                "lock_never_assigned": ["GL402"],
                "module_lock_never_bound": ["GL402"], "pragma_on_def": []}


def _both(src: str, path: str = "pkg/shared.py"):
    """The same text through the JAX and the port GL4xx pass."""
    out = []
    for mod, lock in ((jcore, jlock), (core, tlock)):
        ctx = mod.PackageCtx(repo_root=REPO_ROOT,
                             modules=[mod.ModuleSource(path, src)],
                             registry_checks=False)
        out.append([(f.rule, f.path, f.line, f.symbol, f.message, f.fingerprint)
                    for f in lock.run(ctx)])
    return out


@pytest.mark.parametrize("name", sorted(GL4_SOURCES))
def test_gl4xx_findings_equal_jax(name):
    jax_found, port_found = _both(GL4_SOURCES[name])
    assert port_found == jax_found
    assert sorted({f[0] for f in port_found}) == EXPECTED_GL4[name]


def _guarded_port_modules():
    root = Path(REPO_ROOT) / "pathway_tpu_torch"
    return sorted(p.relative_to(REPO_ROOT).as_posix() for p in root.rglob("*.py")
                  if re.search(r"@guarded_by\(|^_GUARDED_BY = ", p.read_text(), re.M)
                  and "/analysis/" not in p.as_posix())


def test_guarded_port_modules_are_the_jax_ones():
    """JAX's 11 modules that declare a guard all have a counterpart that
    declares one."""
    names = {p.removeprefix("pathway_tpu_torch/") for p in _guarded_port_modules()}
    assert names == {
        "ops/query_server.py", "engine/tracing.py", "engine/async_runtime.py",
        "engine/probes.py", "engine/slo.py", "engine/chaos.py",
        "xpacks/llm/llms.py", "internals/profiling.py", "serving/router.py",
        "serving/hashring.py", "serving/fleet.py"}


@pytest.mark.parametrize("path", _guarded_port_modules())
def test_gl4xx_port_modules_equal_jax_and_clean(path):
    src = (Path(REPO_ROOT) / path).read_text()
    jax_found, port_found = _both(src, path)
    assert port_found == jax_found == []
    # the declarations are live: dropping every `with` of a declared lock
    # makes both passes report the same findings
    stripped = re.sub(r"^(\s*)with (self\.)?_?\w*lock\w*:\s*$", r"\1if True:",
                      src, flags=re.M)
    stripped = re.sub(r"^(\s*)with (self\.)?_(cond|stats_lock)\w*:\s*$",
                      r"\1if True:", stripped, flags=re.M)
    jax_found, port_found = _both(stripped, path)
    assert port_found == jax_found
    assert port_found, f"{path}: no finding once the locks are gone"


def test_fingerprint_pragma_and_baseline_equal_jax(tmp_path):
    a = Finding("GL201", "pathway_tpu_torch/x.py", 10, "msg", "sym")
    b = Finding("GL201", "pathway_tpu_torch/x.py", 99, "msg", "sym")
    c = Finding("GL202", "pathway_tpu_torch/x.py", 10, "msg", "sym")
    assert a.fingerprint == b.fingerprint != c.fingerprint
    assert a.fingerprint == jcore.Finding("GL201", "pathway_tpu_torch/x.py", 7,
                                          "msg", "sym").fingerprint
    src = GL4_SOURCES["pragma_on_def"]
    assert core.ModuleSource("p.py", src).allow == jcore.ModuleSource("p.py", src).allow
    # a baseline written by either package loads in the other
    f2 = Finding("GL203", "pathway_tpu_torch/internals/config.py", 3, "two", "b")
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jcore.save_baseline([jcore.Finding("GL201", a.path, 10, "msg", "sym")], jpath)
    core.save_baseline([a], tpath)
    assert open(jpath).read() == open(tpath).read()
    for path in (jpath, tpath):
        new, old = core.split_baselined([a, f2], core.load_baseline(path))
        assert [f.rule for f in new] == ["GL203"] and [f.rule for f in old] == ["GL201"]
        assert "line" not in json.load(open(path))[0]


def test_rule_ids_are_jax_ids():
    assert list(core.RULES) == list(jcore.RULES)
    for rid in ("GL401", "GL402"):
        assert vars(core.RULES[rid]) == vars(jcore.RULES[rid])


# --------------------------------------------------------- tier-1 gates


def test_port_analyzes_clean_with_an_empty_baseline():
    assert json.load(open(core.DEFAULT_BASELINE)) == []
    findings = core.check(REPO_ROOT)
    assert not findings, "graft-lint findings:\n" + "\n".join(
        f.render() for f in findings)


def test_readme_rules_table_is_generated_output():
    text = open(os.path.join(REPO_ROOT, "README.md"), encoding="utf-8").read()
    m = re.search(r"<!-- torch-analysis:rules -->\n(.*?)<!-- /torch-analysis:rules -->",
                  text, re.S)
    assert m, "README missing <!-- torch-analysis:rules --> block"
    assert m.group(1).strip() == core.render_rules_table().strip()


def test_cli_json_output_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.analysis", "check", "--format", "json"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    out = json.loads(proc.stdout)
    assert set(out) == {"findings", "baselined", "ok"}
    assert out["ok"] is True and proc.returncode == 0


VIOLATIONS = {
    "GL101": LAUNCH_HEAD + "def w(x):\n    print(x)\n    kernels.launch('k', 'f')\n",
    "GL102": LAUNCH_HEAD + "def w(x):\n    kernels.launch('k', 'f', x.item())\n",
    "GL103": LAUNCH_HEAD + "_C = {}\ndef put(k):\n    _C[k] = 1\n"
             "def w(x):\n    kernels.launch('k', 'f', len(_C))\n",
    "GL201": "import os\nX = os.environ.get('PATHWAY_X')\n",
    "GL202": "import os\nX = dict(os.environ)\n",
    "GL401": GL4_SOURCES["unguarded_class_field"],
    "GL402": GL4_SOURCES["lock_never_assigned"],
}


def _tree(tmp_path, files: dict) -> str:
    for rel, text in files.items():
        p = tmp_path / "pathway_tpu_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


@pytest.mark.parametrize("rule", sorted(VIOLATIONS))
def test_cli_exits_1_on_each_source_rule(tmp_path, capsys, rule):
    root = _tree(tmp_path, {"bad.py": VIOLATIONS[rule]})
    assert cli.main(["check", "--root", root, "--format", "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert rule in {f["rule"] for f in out["findings"]}
    assert cli.main(["check", "--root", _tree(tmp_path / "ok", {"ok.py": "X = 1\n"})]) == 0


@pytest.mark.parametrize("rule", ["GL203", "GL204", "GL301", "GL302"])
def test_cli_exits_1_on_each_registry_rule(tmp_path, capsys, monkeypatch, rule):
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_prose.py").write_text('"""paged_kv only here."""\n')
    knob = {
        "GL203": C.Knob("PATHWAY_TPU_X", "bool", False, "DecoderChat", "no_such_arg"),
        "GL204": C.Knob("PATHWAY_TPU_X", "int", 4, "DecoderChat", "paged_kv",
                        tunable=C.Tunable("int", lo=8, hi=1)),
        "GL301": C.Knob("PATHWAY_TPU_X", "bool", False, "DecoderChat", "paged_kv",
                        kill_switch=True, pinned_by="tests/test_gone.py"),
        "GL302": C.Knob("PATHWAY_TPU_X", "bool", False, "DecoderChat", "paged_kv",
                        kill_switch=True, pinned_by="tests/test_prose.py"),
    }[rule]
    monkeypatch.setattr(C, "KNOBS", (knob,))
    files = {"internals/config.py": 'KNOBS = ("X",)\n',
             "xpacks/llm/llms.py": "class DecoderChat:\n"
                                   "    def __init__(self, paged_kv=False):\n        pass\n"}
    root = _tree(tmp_path, files)
    assert cli.main(["check", "--root", root, "--format", "json", "--rules", rule]) == 1
    assert {f["rule"] for f in json.loads(capsys.readouterr().out)["findings"]} == {rule}


def test_cli_list_rules_and_update_baseline(tmp_path, capsys):
    assert cli.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.strip() == core.render_rules_table().strip()
    root = _tree(tmp_path, {"bad.py": VIOLATIONS["GL202"]})
    base = str(tmp_path / "b.json")
    assert cli.main(["check", "--root", root, "--update-baseline", "--baseline", base]) == 0
    capsys.readouterr()
    assert cli.main(["check", "--root", root, "--baseline", base]) == 0
    assert "1 baselined" in capsys.readouterr().out


# ------------------------------------------------------- runtime harness


@pytest.fixture
def sanitizer():
    rt.configure(enabled=True)
    rt.reset()
    yield rt
    rt.disable()
    rt.reset()
    rt.configure(enabled=False)


def test_sanitizer_setting_default_off():
    assert rt.enabled() is False
    rt.configure(enabled=True)
    try:
        assert rt.enabled() is True
    finally:
        rt.configure()
    assert rt.enabled() is False


def test_make_lock_plain_when_off():
    assert isinstance(rt.make_lock("t.off"), type(threading.Lock()))
    assert isinstance(rt.make_lock("t.off", rlock=True), type(threading.RLock()))


def test_seeded_order_inversion_detected(sanitizer):
    a = sanitizer.make_lock("t_inv.A")
    b = sanitizer.make_lock("t_inv.B")
    assert isinstance(a, rt.SanitizedLock)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    inv = sanitizer.reports("order-inversion")
    assert inv, "seeded A->B then B->A inversion not detected"
    assert inv[0]["first"] == "t_inv.B" and inv[0]["second"] == "t_inv.A"


def test_consistent_order_is_clean(sanitizer):
    a = sanitizer.make_lock("t_ord.A")
    b = sanitizer.make_lock("t_ord.B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert sanitizer.reports() == []


def test_reentrant_rlock_no_false_inversion(sanitizer):
    r = sanitizer.make_lock("t_re.R", rlock=True)
    b = sanitizer.make_lock("t_re.B")
    with r:
        with r:
            with b:
                pass
    with r:
        with b:
            pass
    assert sanitizer.reports() == []


def test_unguarded_write_detected(sanitizer):
    @guarded_by(value="_lock")
    class _Guinea:
        def __init__(self):
            self._lock = sanitizer.make_lock("t_guinea.lock")
            self.value = 0

        def good(self):
            with self._lock:
                self.value = 1

        def bad(self):
            self.value = 2

    g = _Guinea()
    sanitizer.enable()
    g.good()
    assert sanitizer.reports("unguarded-write") == []
    g.bad()
    reps = sanitizer.reports("unguarded-write")
    assert reps and reps[0]["field"] == "value"
    assert reps[0]["lock"] == "t_guinea.lock"


def test_condition_wait_release_reacquire_traced(sanitizer):
    cond = threading.Condition(sanitizer.make_lock("t_cond.lock"))
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append(1)
        cond.notify_all()
    t.join(5)
    assert not t.is_alive()
    assert sanitizer.reports() == []


def test_threaded_registry_hammer_clean(sanitizer):
    from pathway_tpu_torch.engine.probes import MetricsRegistry

    reg = MetricsRegistry()
    assert isinstance(reg._lock, rt.SanitizedLock)
    N = 200

    def writer(i):
        for _ in range(N):
            reg.counter_add("hammer_total", 1.0, worker=str(i))
            reg.observe("hammer_seconds", 0.001, worker=str(i))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sum(reg.labelled("hammer_total", "worker").values()) == 8 * N
    assert sanitizer.reports() == []


def test_query_server_under_sanitizer_clean(sanitizer):
    from pathway_tpu_torch.ops.query_server import QueryServer

    class _FakePipe:
        reranker = None

        def retrieve(self, texts, k):
            return [f"{t}:{k}" for t in texts]

    sanitizer.enable()
    try:
        with QueryServer(_FakePipe(), tick_ms=1.0, max_batch=8,
                         queue_bound=16) as srv:
            assert isinstance(srv._stats_lock, rt.SanitizedLock)
            assert isinstance(srv._cond._lock, rt.SanitizedLock)
            results = {}

            def client(i):
                results[i] = srv.submit(f"q{i}", 3).wait(30)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        assert results == {i: f"q{i}:3" for i in range(12)}
    finally:
        sanitizer.disable()
    assert sanitizer.reports() == []


def test_decoder_burst_under_sanitizer_matches_the_plain_arm():
    """A continuous DecoderChat burst (paged KV, flash prefill, chunked
    prefill, spec decode and the prefix cache at their defaults) with the
    sanitizer on: zero reports, its locks sanitized, and the token streams
    of a sanitizer-off server (plain threading locks)."""
    import torch

    from pathway_tpu_torch.models import decoder as TD
    from pathway_tpu_torch.xpacks.llm import DecoderChat
    from tests.utils import ToyCharTokenizer

    cfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                           intermediate=64, max_position=128, dtype=torch.float32)
    params = TD.init_params(torch.Generator().manual_seed(0), cfg)
    tok = ToyCharTokenizer(32)
    prompts = [f"prompt {i} " + "ab" * (i % 5) for i in range(12)]

    def serve(on: bool):
        rt.configure(enabled=on)
        rt.reset()
        if on:
            rt.enable()
        try:
            chat = DecoderChat(params=params, cfg=cfg, tokenizer=tok,
                               max_new_tokens=6, max_prompt_tokens=32,
                               continuous=True, n_slots=4, chunk_steps=4,
                               prefill_chunk=8, paged_kv=True, paged_kv_block=8,
                               paged_kernel=True, flash_prefill=True, device="cpu")
            lock_types = {type(chat.server.lock)}
            try:
                out = {}

                def client(lo, hi):
                    reqs = chat.submit_batch(prompts[lo:hi])
                    for i, r in zip(range(lo, hi), reqs):
                        assert r.done.wait(60), "request hung"
                        out[i] = r.tokens

                ts = [threading.Thread(target=client, args=(i, i + 4))
                      for i in range(0, 12, 4)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(90)
            finally:
                chat.close()
            return [out[i] for i in range(12)], lock_types, rt.reports()
        finally:
            rt.disable()
            rt.configure(enabled=False)

    try:
        on_tokens, on_locks, on_reports = serve(True)
        off_tokens, off_locks, off_reports = serve(False)
    finally:
        rt.reset()
    assert on_reports == []
    assert on_locks == {rt.SanitizedLock}
    assert off_locks == {type(threading.Lock())}
    assert on_tokens == off_tokens
    assert all(len(t) > 0 for t in on_tokens)
