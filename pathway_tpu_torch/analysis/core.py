"""graft-lint core: findings, rule registry, pragmas, baseline
(counterpart of ``pathway_tpu/analysis/core.py``, run over the port).

Stdlib-only on purpose (``ast`` + ``hashlib``): the analyzer must run in
any environment the package imports in, including CI images without an
accelerator, and must stay fast enough to live in tier-1
(``tests/test_torch_analysis.py`` runs :func:`check` over the whole
port in-process).

Vocabulary:

* a **rule** is one enforced invariant with a stable id, JAX's ids
  (``GL1xx`` purity of the kernel launch paths, ``GL2xx`` flag
  hygiene over ``KNOBS``, ``GL3xx`` kill-switch coverage, ``GL4xx``
  lock discipline);
* a **finding** is one violation at a (file, line); its
  :attr:`Finding.fingerprint` hashes rule + file + symbol + message but
  NOT the line number, so baselines survive unrelated edits;
* a **pragma** — ``# graft-lint: allow[rule-id] <reason>`` on the
  offending line or on the enclosing ``def``/``class`` line —
  suppresses a finding in place, for the rare access that is correct
  for reasons the AST cannot see (the suppression is visible in the
  diff, unlike a baseline entry);
* the **baseline** (``pathway_tpu_torch/analysis/baseline.json``) grandfathers
  findings by fingerprint; ``check`` fails only on non-baselined
  findings and ``--update-baseline`` rewrites it. The repo's checked-in
  baseline is EMPTY — every real finding the four passes surfaced was
  fixed, not grandfathered.

The fingerprint, the pragma syntax and the baseline format are JAX's, so
the GL4xx pass, identical in both packages, finds the same findings with
the same fingerprints on the same source text.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re

# --------------------------------------------------------------------- #
# rules


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in [
        Rule(
            "GL101", "launch-host-effect",
            "Host-side effect (print, `time.*`, `os.environ`, a config "
            "read, a probes/tracing/sanitizer call) in a function on a "
            "kernel launch path (one that reaches `kernels.launch`) — "
            "eager PyTorch runs it on every launch, on the host, between "
            "the card's kernels.",
        ),
        Rule(
            "GL102", "launch-host-sync",
            "`np.*` call, `.item()`, `.cpu()`, `.tolist()` or `.numpy()` "
            "on a tensor parameter of a function that reaches "
            "`kernels.launch` — a hidden device-to-host copy that "
            "synchronises the stream on every launch.",
        ),
        Rule(
            "GL103", "launch-mutable-capture",
            "Function on a kernel launch path reads a module-level mutable "
            "that the module also mutates, and the module declares no "
            "`_GUARDED_BY` lock for it — a serving thread may see it "
            "half-updated by another.",
        ),
        Rule(
            "GL201", "flag-env-literal",
            "Literal `PATHWAY*` environment read outside "
            "`internals/config.py` — the port reads no flag: make the knob "
            "a constructor argument or an `EngineConfig` field.",
        ),
        Rule(
            "GL202", "flag-env-indirect",
            "Other `os.environ` / `os.getenv` use outside "
            "`internals/config.py` — route through the choke points in "
            "`internals/config.py` (`env_interpolate`, "
            "`environ_snapshot`, `launcher_env`) so environment reads stay "
            "auditable.",
        ),
        Rule(
            "GL203", "flag-dead",
            "`KNOBS` entry whose argument no constructor takes (its "
            "`target`'s constructor or `configure` has no parameter or "
            "field named `arg`) — a tuned config would set nothing.",
        ),
        Rule(
            "GL204", "tunable-bounds",
            "`KNOBS` entry with a `Tunable` search spec whose bounds are "
            "missing/non-finite, whose candidate ladder is empty or "
            "degenerate, or whose default falls outside the declared "
            "range — the autotuner would search a broken space.",
        ),
        Rule(
            "GL301", "kill-switch-unpinned",
            "`KNOBS` entry marked `kill_switch=True` without a live "
            "pinning test: `pinned_by` must name an existing port test "
            "file that references the knob's argument.",
        ),
        Rule(
            "GL302", "kill-switch-pin-prose-only",
            "Kill switch's `pinned_by` test names the argument only in "
            "docstrings/comments — the test must pass it in code (a "
            "keyword argument, a parametrize entry, a dict key), or the "
            "pin is prose, not a test.",
        ),
        Rule(
            "GL401", "lock-unguarded-access",
            "Access to a `guarded_by`-declared field outside a `with "
            "<lock>:` block (and not in `__init__` or an "
            "`@assumes_held` method).",
        ),
        Rule(
            "GL402", "lock-undeclared",
            "`guarded_by` declaration names a lock attribute the class "
            "(or module) never assigns — the guard cannot exist.",
        ),
    ]
}


# --------------------------------------------------------------------- #
# findings


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    symbol: str = ""  # function / class / flag the finding anchors to

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{self.symbol}|{self.message}".encode()
        ).hexdigest()
        return h[:12]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "name": RULES[self.rule].name,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (
            f"{self.path}:{self.line}: {self.rule} "
            f"({RULES[self.rule].name}){sym} {self.message}"
        )


# --------------------------------------------------------------------- #
# sources + pragmas

_PRAGMA_RE = re.compile(r"graft-lint:\s*allow\[([A-Za-z0-9_*,\- ]+)\]")


class ModuleSource:
    """One parsed package module: AST + per-line pragma index."""

    def __init__(self, path: str, text: str):
        self.path = path  # repo-relative
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.lines = text.splitlines()
        self.allow: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                # accept rule ids and rule names alike
                names = {r.name: r.id for r in RULES.values()}
                self.allow[i] = {names.get(s, s) for s in ids}

    def allowed(self, rule: str, *linenos: int) -> bool:
        for ln in linenos:
            ids = self.allow.get(ln)
            if ids and (rule in ids or "*" in ids):
                return True
        return False

    def emit(
        self,
        out: list[Finding],
        rule: str,
        node: ast.AST,
        message: str,
        symbol: str = "",
        scope_line: int | None = None,
    ) -> None:
        """Append a finding unless a pragma on the node's line (or its
        enclosing definition's line) allows the rule."""
        line = getattr(node, "lineno", 0)
        scopes = (line,) if scope_line is None else (line, scope_line)
        if not self.allowed(rule, *scopes):
            out.append(Finding(rule, self.path, line, message, symbol))


@dataclasses.dataclass
class PackageCtx:
    """Everything a pass may look at: the parsed package, plus the repo
    root for cross-referencing tests/."""

    repo_root: str
    modules: list[ModuleSource]
    # False on single-snippet runs (analyze_source): the registry-wide
    # checks (GL203 dead knobs, GL301 kill switches) compare the LIVE
    # KNOBS table against the scanned sources, which is meaningless
    # when the "package" is one synthetic module
    registry_checks: bool = True

    def module(self, relpath: str) -> ModuleSource | None:
        for m in self.modules:
            if m.path == relpath:
                return m
        return None


def collect_package(repo_root: str, package: str = "pathway_tpu_torch") -> PackageCtx:
    modules: list[ModuleSource] = []
    pkg_root = os.path.join(repo_root, package)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__"
        )
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, repo_root).replace(os.sep, "/")
            with open(full, encoding="utf-8") as f:
                modules.append(ModuleSource(rel, f.read()))
    return PackageCtx(repo_root=repo_root, modules=modules)


# --------------------------------------------------------------------- #
# running


def _passes():
    from pathway_tpu_torch.analysis import (
        flag_hygiene,
        jit_purity,
        kill_switch,
        lock_discipline,
    )

    return {
        "GL1": jit_purity.run,
        "GL2": flag_hygiene.run,
        "GL3": kill_switch.run,
        "GL4": lock_discipline.run,
    }


def check(repo_root: str, rules: set[str] | None = None) -> list[Finding]:
    """Run every pass (or the ones owning ids in ``rules``) over the
    package at ``repo_root``; findings sorted by (path, line, rule)."""
    ctx = collect_package(repo_root)
    findings: list[Finding] = []
    for prefix, run in _passes().items():
        if rules is not None and not any(r.startswith(prefix) for r in rules):
            continue
        findings.extend(run(ctx))
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def analyze_source(
    src: str, path: str = "pathway_tpu_torch/_synthetic.py",
    rules: set[str] | None = None, repo_root: str | None = None,
) -> list[Finding]:
    """Run the AST passes over one synthetic module — the unit-test
    entry point (``tests/test_torch_analysis.py`` feeds each rule a
    good and a bad snippet through this)."""
    ctx = PackageCtx(
        repo_root=repo_root or os.getcwd(),
        modules=[ModuleSource(path, src)],
        registry_checks=False,
    )
    findings: list[Finding] = []
    for prefix, run in _passes().items():
        if prefix == "GL3" and repo_root is None:
            continue  # registry-wide pass is meaningless on one snippet
        if rules is not None and not any(r.startswith(prefix) for r in rules):
            continue
        findings.extend(run(ctx))
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# --------------------------------------------------------------------- #
# baseline

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(__file__), "baseline.json"
)


def load_baseline(path: str | None = None) -> set[str]:
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    return {e["fingerprint"] for e in entries}


def save_baseline(findings: list[Finding], path: str | None = None) -> str:
    path = path or DEFAULT_BASELINE
    entries = [f.to_dict() for f in findings]
    for e in entries:
        e.pop("line", None)  # lines churn; fingerprints don't
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def split_baselined(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """(new, grandfathered) partition of ``findings``."""
    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]
    return new, old


# --------------------------------------------------------------------- #
# docs


def render_rules_table() -> str:
    """The README rule table (``tests/test_torch_analysis.py`` pins the
    README's ``torch-analysis:rules`` block to it)."""
    lines = [
        "| Rule | Name | Enforces |",
        "|---|---|---|",
    ]
    for r in RULES.values():
        lines.append(f"| `{r.id}` | `{r.name}` | {r.summary} |")
    return "\n".join(lines)
