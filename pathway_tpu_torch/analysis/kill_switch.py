"""GL3xx — kill-switch coverage pass (counterpart of
``pathway_tpu/analysis/kill_switch.py``, retargeted at the port).

JAX's registry marks every perf feature's env kill switch
(``Flag.kill_switch=True``) with the test that pins the killed path
byte-identical (``pinned_by``). The port's switches are constructor
arguments, so ``internals/config.py``'s ``KNOBS`` carries the same two
fields and the contract is about the argument:

* **GL301** — the named port test file must exist and must reference the
  knob's argument (a renamed or deleted pinning test un-pins the switch
  and fails the analyzer, not a human's memory).
* **GL302** — the argument must appear in the pinning test's *code*: a
  keyword argument of a call (``DecoderChat(..., paged_kv=False)``), or a
  string literal outside docstrings (a parametrize entry, a dict key fed
  as ``**kwargs``). A mention that lives only in a docstring or comment
  satisfies GL301's scan while pinning nothing.

Registry-wide by nature: runs only on full-package scans (needs
``internals/config.py`` in the scanned set). Unit tests drive
:func:`check_kill_switches` / :func:`check_pinning_refs` directly with
synthetic tables and a tmp_path tests tree.
"""

from __future__ import annotations

import ast
import os
import re

from pathway_tpu_torch.analysis.core import Finding, PackageCtx
from pathway_tpu_torch.analysis.flag_hygiene import CONFIG_PATH, _registry_line


def check_kill_switches(flags, repo_root: str) -> list[tuple[str, str]]:
    """``[(env, problem), ...]`` for every ``kill_switch=True`` knob whose
    pinning contract is broken (its test must reference ``knob.arg``)."""
    problems: list[tuple[str, str]] = []
    for flag in flags:
        if not getattr(flag, "kill_switch", False):
            continue
        pinned_by = getattr(flag, "pinned_by", None)
        if not pinned_by:
            problems.append(
                (flag.env, "kill_switch=True but no `pinned_by=` test file")
            )
            continue
        full = os.path.join(repo_root, pinned_by)
        if not os.path.exists(full):
            problems.append(
                (flag.env, f"pinned_by `{pinned_by}` does not exist")
            )
            continue
        with open(full, encoding="utf-8") as f:
            if not _mentions(f.read(), flag.arg):
                problems.append(
                    (flag.env,
                     f"pinned_by `{pinned_by}` never references `{flag.arg}` "
                     "— the pinning test is gone or renamed")
                )
    return problems


def _mentions(text: str, arg: str) -> bool:
    return re.search(r"\b" + re.escape(arg) + r"\b", text) is not None


def _code_strings(source: str) -> list[str]:
    """Every string literal in ``source`` that is NOT a docstring.

    Comments never reach the AST and module/class/function docstrings are
    the leading ``Expr``-statement constants of their bodies — everything
    left is a literal the code actually uses (a ``setenv`` argument, a
    parametrize list entry, an env dict key, ...).
    """
    tree = ast.parse(source)
    doc_nodes: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                doc_nodes.add(id(body[0].value))
    out: list[str] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in doc_nodes
        ):
            out.append(node.value)
    return out


def _keyword_args(source: str) -> set[str]:
    """Every keyword-argument name passed in a call in ``source``."""
    return {
        kw.arg
        for node in ast.walk(ast.parse(source))
        if isinstance(node, ast.Call)
        for kw in node.keywords
        if kw.arg
    }


def check_pinning_refs(flags, repo_root: str) -> list[tuple[str, str]]:
    """``[(env, problem), ...]`` for every kill switch whose pinning test
    names the argument ONLY in prose (docstrings/comments) — a
    reference GL301's scan accepts but which pins nothing."""
    problems: list[tuple[str, str]] = []
    for flag in flags:
        if not getattr(flag, "kill_switch", False):
            continue
        pinned_by = getattr(flag, "pinned_by", None)
        if not pinned_by:
            continue  # GL301's finding; nothing further to refine
        full = os.path.join(repo_root, pinned_by)
        if not os.path.exists(full):
            continue  # GL301's finding
        with open(full, encoding="utf-8") as f:
            source = f.read()
        if not _mentions(source, flag.arg):
            continue  # GL301's finding
        try:
            strings = _code_strings(source)
            keywords = _keyword_args(source)
        except SyntaxError:
            continue  # unparseable test file fails loudly elsewhere
        if flag.arg not in keywords and flag.arg not in strings:
            problems.append(
                (flag.env,
                 f"pinned_by `{pinned_by}` mentions `{flag.arg}` only in "
                 "docstrings/comments — the test must pass the argument in "
                 "code (keyword / parametrize / kwargs dict)")
            )
    return problems


def run(ctx: PackageCtx) -> list[Finding]:
    config = ctx.module(CONFIG_PATH)
    if config is None or not ctx.registry_checks:
        return []
    from pathway_tpu_torch.internals.config import KNOBS

    findings: list[Finding] = []
    for rule, checker in (
        ("GL301", check_kill_switches),
        ("GL302", check_pinning_refs),
    ):
        for env, problem in checker(KNOBS, ctx.repo_root):
            line = _registry_line(config, env)
            node = ast.Constant(value=env)
            node.lineno = line
            config.emit(findings, rule, node, f"`{env}`: {problem}", env)
    return findings
