"""GL1xx — launch-path purity pass (counterpart of
``pathway_tpu/analysis/jit_purity.py``, retargeted at the port).

JAX's pass roots at ``jax.jit`` / ``pl.pallas_call`` / ``shard_map``
boundaries, where a host effect runs at trace time. The port has no
``jax.jit``, no ``torch.compile`` and no CUDA graphs: it runs eagerly, and
its one boundary with the card's own code is ``kernels.launch``
(``pathway_tpu_torch/kernels.py``), the ctypes call into a hand-written
kernel. So the roots here are the functions that **reach
``kernels.launch``**: each function that calls it, and, within the same
module, each function that calls one of those (``flash_attn``,
``flash_chunk_attn`` through ``_launch_chunk``, ``paged_attn_decode``
through ``_launch``, ``wq_matmul``). The launch path is the roots plus
what they call, resolved by name across modules as JAX's pass resolves
it, but never into ``kernels.py`` itself (the boundary's machinery: the
one-time build, the library cache) nor into the observability modules
(a call into them is the finding). Inside the launch path:

* **GL101** host-side effects: ``print``, ``time.*``, ``os.environ`` /
  ``os.getenv``, calls into ``internals/config.py`` (the port's config
  reads), and calls into the observability modules (``engine.probes`` /
  ``engine.tracing`` / ``analysis.runtime``). Eager PyTorch does not
  freeze them as a trace would: it runs them on every launch, on the
  host, between the card's kernels — the cost lands on the serving
  loop's critical path.
* **GL102** ``np.*`` calls on, or ``.item()`` / ``.cpu()`` /
  ``.tolist()`` / ``.numpy()`` of, a parameter of a root (the root's
  parameters are the tensors handed to the kernel). Each is a hidden
  device-to-host copy that synchronises the stream on every launch.
* **GL103** a read of a module-level mutable that the module also
  mutates, when the module's ``_GUARDED_BY`` declares no lock for it:
  serving threads launch concurrently, and an unguarded shared mutable
  on the launch path can be read half-updated.

Reachability is per-function / by name, as in JAX's pass: top-level
functions only. Method calls and dynamic dispatch are out of scope.
"""

from __future__ import annotations

import ast

from pathway_tpu_torch.analysis.core import Finding, ModuleSource, PackageCtx

_TIME_FNS = {
    "time", "perf_counter", "perf_counter_ns", "monotonic", "sleep",
    "process_time", "time_ns", "monotonic_ns",
}
_NUMPY_MODULES = {"numpy"}
_KERNELS_MODULE = "pathway_tpu_torch.kernels"
_CONFIG_MODULE = "pathway_tpu_torch.internals.config"
_EFFECT_MODULES = (
    "pathway_tpu_torch.engine.probes",
    "pathway_tpu_torch.engine.tracing",
    "pathway_tpu_torch.analysis.runtime",
)
# methods of a tensor that copy it to the host
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "appendleft",
}


def _module_name(path: str) -> str:
    # "pathway_tpu_torch/ops/knn.py" -> "pathway_tpu_torch.ops.knn";
    # ".../__init__.py" -> package name
    mod = path[:-3] if path.endswith(".py") else path
    parts = mod.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Imports:
    """Per-module import resolution: local alias -> what it names."""

    def __init__(self, src: ModuleSource):
        self.mod_alias: dict[str, str] = {}  # name -> imported module
        self.from_names: dict[str, tuple[str, str]] = {}  # name -> (mod, orig)
        pkg_parts = _module_name(src.path).split(".")
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_alias[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # relative: drop the module's own name + (level-1) more
                    anchor = pkg_parts[: len(pkg_parts) - node.level]
                    base = ".".join(anchor + ([base] if base else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    self.from_names[local] = (base, a.name)
                    # `from pkg import submodule` also binds a module
                    self.mod_alias.setdefault(local, f"{base}.{a.name}")

    def module_of(self, name: str) -> str | None:
        if name in self.from_names:
            return self.from_names[name][0]
        return self.mod_alias.get(name)


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_launch(node: ast.AST, imps: _Imports) -> bool:
    """``kernels.launch`` (any alias of the kernels module, imported at
    module level or inside a function) or a from-imported ``launch``."""
    d = _dotted(node)
    if d is None:
        return False
    head, _, tail = d.partition(".")
    if tail == "launch" and _KERNELS_MODULE in (imps.module_of(head),
                                                imps.mod_alias.get(head)):
        return True
    return not tail and imps.from_names.get(head) == (_KERNELS_MODULE, "launch")


class _FuncRef:
    __slots__ = ("src", "node", "entry")

    def __init__(self, src: ModuleSource, node: ast.FunctionDef):
        self.src = src
        self.node = node
        self.entry = False  # reaches kernels.launch (a root)


def _call_edges(
    fn: ast.FunctionDef, imps: _Imports, defs: dict[str, ast.FunctionDef],
):
    """(module|None, name) pairs for every resolvable call in fn."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in defs:
                yield None, f.id
            elif f.id in imps.from_names:
                mod, orig = imps.from_names[f.id]
                yield mod, orig
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            mod = imps.module_of(f.value.id)
            if mod:
                yield mod, f.attr


def _module_mutated_names(src: ModuleSource) -> set[str]:
    """Module-level names the module itself mutates somewhere."""
    out: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATOR_METHODS
                and isinstance(f.value, ast.Name)
            ):
                out.add(f.value.id)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AugAssign)
                else node.targets
            )
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name
                ):
                    out.add(t.value.id)
        elif isinstance(node, ast.Global):
            out.update(node.names)
    return out


def _module_mutable_globals(src: ModuleSource) -> dict[str, int]:
    """Top-level names bound to mutable literals -> lineno."""
    out: dict[str, int] = {}
    for node in src.tree.body:
        if isinstance(node, ast.Assign):
            val = node.value
            mutable = isinstance(
                val, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                      ast.SetComp)
            ) or (
                isinstance(val, ast.Call)
                and isinstance(val.func, ast.Name)
                and val.func.id in ("list", "dict", "set", "bytearray",
                                    "defaultdict", "deque")
            )
            if mutable:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.lineno
    return out


def _module_guarded_names(src: ModuleSource) -> set[str]:
    """Names the module's top-level ``_GUARDED_BY`` dict declares."""
    for node in src.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "_GUARDED_BY"
            and isinstance(node.value, ast.Dict)
        ):
            return {
                k.value for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return set()


def _local_names(fn: ast.FunctionDef) -> set[str]:
    """Names bound inside fn (params, assignments, comprehensions,...)."""
    bound: set[str] = set()
    a = fn.args
    for arg in (
        list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
        + ([a.vararg] if a.vararg else []) + ([a.kwarg] if a.kwarg else [])
    ):
        bound.add(arg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                bound.add(node.name)
        elif isinstance(node, ast.comprehension):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    bound.add(sub.id)
    return bound


def _collect_roots(
    by_name: dict[str, dict[str, _FuncRef]],
    imports: dict[str, _Imports],
) -> list[_FuncRef]:
    """Functions that call ``kernels.launch``, closed over their callers
    within the same module."""
    roots: list[_FuncRef] = []
    for mod, refs in by_name.items():
        imps = imports[mod]
        defs = {n: r.node for n, r in refs.items()}
        hit = {
            name for name, ref in refs.items()
            if any(isinstance(n, ast.Call) and _is_launch(n.func, imps)
                   for n in ast.walk(ref.node))
        }
        grew = bool(hit)
        while grew:
            grew = False
            for name, ref in refs.items():
                if name in hit:
                    continue
                if any(cmod is None and cname in hit
                       for cmod, cname in _call_edges(ref.node, imps, defs)):
                    hit.add(name)
                    grew = True
        for name in sorted(hit):
            refs[name].entry = True
            roots.append(refs[name])
    return roots


def run(ctx: PackageCtx) -> list[Finding]:
    sources = {_module_name(m.path): m for m in ctx.modules}
    imports = {mod: _Imports(src) for mod, src in sources.items()}
    by_name: dict[str, dict[str, _FuncRef]] = {}
    for mod, src in sources.items():
        by_name[mod] = {
            node.name: _FuncRef(src, node)
            for node in src.tree.body
            if isinstance(node, ast.FunctionDef)
        }

    roots = _collect_roots(by_name, imports)

    # BFS over the name-resolved call graph, stopping at the boundary
    reachable: dict[tuple[str, str], _FuncRef] = {}
    frontier = [
        (_module_name(r.src.path), r.node.name, r) for r in roots
    ]
    while frontier:
        mod, name, ref = frontier.pop()
        key = (mod, name)
        if key in reachable:
            continue
        reachable[key] = ref
        imps = imports[mod]
        defs = {n: r.node for n, r in by_name.get(mod, {}).items()}
        for cmod, cname in _call_edges(ref.node, imps, defs):
            owner = cmod or mod
            if owner == _KERNELS_MODULE or owner.startswith(_EFFECT_MODULES):
                continue
            cref = by_name.get(owner, {}).get(cname)
            if cref is not None and (owner, cname) not in reachable:
                frontier.append((owner, cname, cref))

    findings: list[Finding] = []
    mutated_cache: dict[str, set[str]] = {}
    mutables_cache: dict[str, dict[str, int]] = {}

    for (mod, name), ref in sorted(reachable.items()):
        src, fn, imps = ref.src, ref.node, imports[mod]
        _check_host_effects(findings, src, fn, imps, name)
        if ref.entry:
            _check_host_sync(findings, src, fn, imps, name)
        if mod not in mutated_cache:
            mutated_cache[mod] = (_module_mutated_names(src)
                                  - _module_guarded_names(src))
            mutables_cache[mod] = _module_mutable_globals(src)
        _check_mutable_capture(
            findings, src, fn, name,
            mutables_cache[mod], mutated_cache[mod],
        )
    return findings


def _attr_owner(imps: _Imports, name: str) -> str | None:
    """The module ``name.attr`` reads from: ``from pkg import mod`` binds
    the submodule ``pkg.mod`` (JAX's pass resolves it to ``pkg``)."""
    return imps.mod_alias.get(name) or imps.module_of(name)


def _check_host_effects(
    out: list[Finding], src: ModuleSource, fn: ast.FunctionDef,
    imps: _Imports, fname: str,
) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == "print":
                src.emit(out, "GL101", node,
                         "`print` on a kernel launch path",
                         fname, fn.lineno)
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                owner = _attr_owner(imps, f.value.id)
                if owner == "time" and f.attr in _TIME_FNS:
                    src.emit(out, "GL101", node,
                             f"`time.{f.attr}` on a kernel launch path",
                             fname, fn.lineno)
                elif owner == "os" and f.attr == "getenv":
                    src.emit(out, "GL101", node,
                             "`os.getenv` on a kernel launch path",
                             fname, fn.lineno)
                elif owner == _CONFIG_MODULE:
                    src.emit(out, "GL101", node,
                             f"config read `{f.value.id}.{f.attr}` on a "
                             "kernel launch path",
                             fname, fn.lineno)
                elif owner and owner.startswith(_EFFECT_MODULES):
                    src.emit(
                        out, "GL101", node,
                        f"observability call `{f.value.id}.{f.attr}` on a "
                        "kernel launch path",
                        fname, fn.lineno,
                    )
            if isinstance(f, ast.Name) and f.id in imps.from_names:
                owner, _orig = imps.from_names[f.id]
                if owner == _CONFIG_MODULE:
                    src.emit(out, "GL101", node,
                             f"config read `{f.id}` on a kernel launch path",
                             fname, fn.lineno)
                elif owner.startswith(_EFFECT_MODULES):
                    src.emit(
                        out, "GL101", node,
                        f"observability call `{f.id}` on a kernel launch "
                        "path",
                        fname, fn.lineno,
                    )
        elif isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            owner = _attr_owner(imps, node.value.id)
            if owner == "os" and node.attr == "environ":
                src.emit(out, "GL101", node,
                         "`os.environ` on a kernel launch path",
                         fname, fn.lineno)


def _check_host_sync(
    out: list[Finding], src: ModuleSource, fn: ast.FunctionDef,
    imps: _Imports, fname: str,
) -> None:
    a = fn.args
    params = {arg.arg for arg in list(a.posonlyargs) + list(a.args)
              + list(a.kwonlyargs)}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        # x.item() / x.cpu() / x.tolist() / x.numpy() on a parameter
        if (f.attr in _SYNC_METHODS and isinstance(f.value, ast.Name)
                and f.value.id in params):
            src.emit(
                out, "GL102", node,
                f"`{f.value.id}.{f.attr}()` on parameter `{f.value.id}` of "
                f"`{fname}`, which reaches kernels.launch",
                fname, fn.lineno,
            )
            continue
        if not isinstance(f.value, ast.Name):
            continue
        if imps.module_of(f.value.id) not in _NUMPY_MODULES:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in params:
                src.emit(
                    out, "GL102", node,
                    f"`{f.value.id}.{f.attr}({arg.id})` on parameter "
                    f"`{arg.id}` of `{fname}`, which reaches kernels.launch",
                    fname, fn.lineno,
                )
                break


def _check_mutable_capture(
    out: list[Finding], src: ModuleSource, fn: ast.FunctionDef,
    fname: str, mutables: dict[str, int], mutated: set[str],
) -> None:
    if not mutables:
        return
    bound = _local_names(fn)
    seen: set[str] = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)):
            continue
        nm = node.id
        if nm in bound or nm in seen or nm not in mutables:
            continue
        if nm not in mutated:
            continue  # never mutated, or guarded by a declared lock
        seen.add(nm)
        src.emit(
            out, "GL103", node,
            f"`{fname}` on a kernel launch path reads module-level mutable "
            f"`{nm}` (mutated elsewhere in {src.path}) with no `_GUARDED_BY` "
            "lock",
            fname, fn.lineno,
        )
