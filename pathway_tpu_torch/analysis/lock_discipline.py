"""GL4xx — lock-discipline pass.

Enforces the ``guarded_by`` declarations from
``pathway_tpu_torch/analysis/annotations.py``:

* classes — ``@guarded_by(_counters="_lock")`` requires every
  ``self._counters`` access in the class body to sit lexically inside
  ``with self._lock:`` (**GL401**). ``__init__`` is exempt
  (construction precedes publication); a method decorated
  ``@assumes_held("_lock")`` is exempt for that lock's fields — the
  contract moves to its callers, which the pass still checks.
* modules — a top-level ``_GUARDED_BY = {"_ring": "_ring_lock"}`` dict
  declares module globals the same way; accesses inside functions must
  sit inside ``with _ring_lock:``; top-level statements (import-time
  construction) are exempt.
* **GL402** — a declaration naming a lock the class never assigns
  (``self.<lock> = ...`` nowhere) or the module never binds: the guard
  cannot exist, the declaration is a typo.

The check is lexical on purpose: aliasing the lock
(``c = self._cond; with c:``) defeats it and earns a finding — write
the ``with`` on the attribute, or pragma with a reason. The *dynamic*
complement (lock-order inversions, writes through setattr paths the
AST never sees) is ``analysis/runtime.py``'s job.
"""

from __future__ import annotations

import ast

from pathway_tpu_torch.analysis.core import Finding, ModuleSource, PackageCtx


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _decorator_call(dec: ast.AST, suffix: str) -> ast.Call | None:
    if isinstance(dec, ast.Call):
        d = _dotted(dec.func)
        if d and (d == suffix or d.endswith("." + suffix)):
            return dec
    return None


def _guarded_decl(cls: ast.ClassDef) -> dict[str, str]:
    out: dict[str, str] = {}
    for dec in cls.decorator_list:
        call = _decorator_call(dec, "guarded_by")
        if call is None:
            continue
        for kw in call.keywords:
            if kw.arg and isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, str
            ):
                out[kw.arg] = kw.value.value
    return out


def _assumes_held(fn: ast.FunctionDef) -> set[str]:
    held: set[str] = set()
    for dec in fn.decorator_list:
        call = _decorator_call(dec, "assumes_held")
        if call and call.args and isinstance(call.args[0], ast.Constant):
            held.add(str(call.args[0].value))
    return held


def _module_guarded(src: ModuleSource) -> tuple[dict[str, str], int]:
    """Top-level ``_GUARDED_BY = {...}`` declaration -> (mapping, line)."""
    for node in src.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "_GUARDED_BY"
            and isinstance(node.value, ast.Dict)
        ):
            out: dict[str, str] = {}
            for k, v in zip(node.value.keys, node.value.values):
                if (
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    out[k.value] = v.value
            return out, node.lineno
    return {}, 0


def _visit_with_locks(
    node: ast.AST, active: frozenset, cb, _root: bool = True
) -> None:
    """Pre-order walk threading the set of lexically-held lock
    expressions (dotted strings) through ``with`` blocks. Does not
    descend into nested def/class bodies — those run later, when the
    lock is no longer held (each function is visited on its own)."""
    cb(node, active)
    if not _root and isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
    ):
        return
    if isinstance(node, ast.With):
        acquired = set()
        for item in node.items:
            d = _dotted(item.context_expr)
            if d:
                acquired.add(d)
        active = active | acquired
    for child in ast.iter_child_nodes(node):
        _visit_with_locks(child, active, cb, _root=False)


def _self_assigns(cls: ast.ClassDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(cls):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.ctx, ast.Store)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            out.add(node.attr)
    return out


def run(ctx: PackageCtx) -> list[Finding]:
    findings: list[Finding] = []
    for src in ctx.modules:
        _check_classes(findings, src)
        _check_module_globals(findings, src)
    return findings


def _check_classes(out: list[Finding], src: ModuleSource) -> None:
    for cls in ast.walk(src.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = _guarded_decl(cls)
        if not guarded:
            continue
        assigned = _self_assigns(cls)
        for lock_attr in sorted(set(guarded.values())):
            if lock_attr not in assigned:
                src.emit(
                    out, "GL402", cls,
                    f"guarded_by names lock `self.{lock_attr}` which "
                    f"`{cls.name}` never assigns",
                    cls.name,
                )
        # walk ALL function defs in the class — nested closures run
        # later, outside any lock their definition site held, and each
        # is visited as its own root with an empty held set
        for fn in ast.walk(cls):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            exempt = _assumes_held(fn)

            def cb(node, active, fn=fn, exempt=exempt):
                if not (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in guarded
                ):
                    return
                lock_attr = guarded[node.attr]
                if lock_attr in exempt:
                    return
                if f"self.{lock_attr}" in active:
                    return
                src.emit(
                    out, "GL401", node,
                    f"`self.{node.attr}` accessed outside `with "
                    f"self.{lock_attr}:` in `{cls.name}.{fn.name}`",
                    f"{cls.name}.{fn.name}", fn.lineno,
                )

            _visit_with_locks(fn, frozenset(), cb)


def _check_module_globals(out: list[Finding], src: ModuleSource) -> None:
    guarded, decl_line = _module_guarded(src)
    if not guarded:
        return
    top_assigned = {
        t.id
        for node in src.tree.body
        if isinstance(node, ast.Assign)
        for t in node.targets
        if isinstance(t, ast.Name)
    }
    for lock_name in sorted(set(guarded.values())):
        if lock_name not in top_assigned:
            anchor = ast.Constant(value=lock_name)
            anchor.lineno = decl_line
            src.emit(
                out, "GL402", anchor,
                f"_GUARDED_BY names lock `{lock_name}` which {src.path} "
                "never binds at module level",
                lock_name,
            )
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        exempt = _assumes_held(fn) if isinstance(fn, ast.FunctionDef) else set()

        def cb(node, active, fn=fn, exempt=exempt):
            if not (
                isinstance(node, ast.Name)
                and node.id in guarded
                and isinstance(node.ctx, (ast.Load, ast.Store, ast.Del))
            ):
                return
            lock_name = guarded[node.id]
            if lock_name in exempt or lock_name in active:
                return
            src.emit(
                out, "GL401", node,
                f"module global `{node.id}` accessed outside `with "
                f"{lock_name}:` in `{fn.name}`",
                fn.name, fn.lineno,
            )

        _visit_with_locks(fn, frozenset(), cb)
