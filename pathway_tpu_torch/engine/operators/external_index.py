"""External-index operator: streams (index-adds, queries) into a per-worker
index instance with as-of-now query semantics.

Reference parity: ``src/engine/dataflow/operators/external_index.rs``
(``UseExternalIndexAsOfNow``) + ``src/external_integration/mod.rs``
(``ExternalIndex``/``ExternalIndexFactory``, one instance per worker,
``NonFilteringExternalIndex`` + filtered wrapper).
"""

from __future__ import annotations

import functools
import re
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.value import ERROR, Pointer
from pathway_tpu_torch.internals.errors import get_global_error_log


class ExternalIndexFactory:
    """Builds one index instance per worker (reference mod.rs:46)."""

    def make_instance(self):
        raise NotImplementedError


class ExternalIndexNode(Node):
    """Inputs: index stream (vector col [+ filter-data col]) and query stream
    (query vector col [+ limit col, + filter col]). Output: per query key a
    ``_pw_index_reply`` column holding a tuple of (Pointer, score) pairs.

    As-of-now: queries are answered once at arrival against the current index
    state; new documents do NOT retrigger old queries (matching the
    reference's forget-after-answer semantics).
    """

    def __init__(
        self,
        graph,
        index_input,
        query_input,
        *,
        index_factory: ExternalIndexFactory,
        vector_col: str,
        query_vector_col: str,
        limit_col: str | None = None,
        filter_data_col: str | None = None,
        query_filter_col: str | None = None,
        default_limit: int = 3,
        name="ExternalIndex",
    ):
        super().__init__(graph, [index_input, query_input], ["_pw_index_reply"], name)
        self.index_factory = index_factory
        self.vector_col = vector_col
        self.query_vector_col = query_vector_col
        self.limit_col = limit_col
        self.filter_data_col = filter_data_col
        self.query_filter_col = query_filter_col
        self.default_limit = default_limit
        self._index = None
        self._filter_data: dict[int, Any] = {}
        self._answered: dict[int, tuple] = {}

    def reset(self):
        self._index = None
        self._filter_data = {}
        self._answered = {}

    def _ensure_index(self):
        if self._index is None:
            self._index = self.index_factory.make_instance()
        return self._index

    def step(self, time, ins):
        idx_batch, q_batch = ins
        index = self._ensure_index()
        if idx_batch is not None and len(idx_batch) > 0:
            names = self.inputs[0].column_names
            vi = names.index(self.vector_col)
            fi = names.index(self.filter_data_col) if self.filter_data_col else None
            add_keys, add_vecs, rm_keys = [], [], []
            for key, row, diff in idx_batch.rows():
                vec = row[vi]
                if vec is ERROR:
                    get_global_error_log().log("Error value in index vector column")
                    continue
                if diff > 0:
                    add_keys.append(key)
                    add_vecs.append(vec)
                    if fi is not None:
                        self._filter_data[key] = row[fi]
                else:
                    rm_keys.append(key)
                    self._filter_data.pop(key, None)
            if rm_keys:
                index.remove(rm_keys)
            if add_keys:
                index.add(add_keys, add_vecs)
        out_rows: list[tuple[int, tuple, int]] = []
        if q_batch is not None and len(q_batch) > 0:
            names = self.inputs[1].column_names
            qi = names.index(self.query_vector_col)
            li = names.index(self.limit_col) if self.limit_col else None
            fqi = names.index(self.query_filter_col) if self.query_filter_col else None
            adds = [(k, row) for k, row, d in q_batch.rows() if d > 0]
            dels = [(k, row) for k, row, d in q_batch.rows() if d < 0]
            for key, _row in dels:
                prev = self._answered.pop(key, None)
                if prev is not None:
                    out_rows.append((key, prev, -1))
            if adds:
                vecs = []
                metas = []
                for key, row in adds:
                    v = row[qi]
                    if v is ERROR or v is None:
                        out_rows.append((key, ((),), 1))
                        self._answered[key] = ((),)
                        continue
                    vecs.append(v)
                    metas.append((key, row))
                if vecs:
                    limits = [
                        (
                            int(row[li])
                            if li is not None and row[li] is not None
                            else self.default_limit
                        )
                        for _k, row in metas
                    ]
                    kmax = max(limits)
                    # over-fetch when filtering post-hoc
                    fetch_k = kmax * 4 if fqi is not None else kmax
                    results = index.search(vecs, fetch_k)
                    for (key, row), limit, matches in zip(metas, limits, results):
                        if fqi is not None and row[fqi] is not None:
                            flt = row[fqi]
                            matches = [
                                (mk, s)
                                for mk, s in matches
                                if _apply_filter(flt, self._filter_data.get(mk))
                            ]
                        matches = matches[:limit]
                        reply = tuple(
                            (Pointer(mk), float(s)) for mk, s in matches
                        )
                        out_rows.append((key, (reply,), 1))
                        self._answered[key] = (reply,)
        if not out_rows:
            return None
        return Batch.from_rows(self.column_names, out_rows)


def _apply_filter(flt, data) -> bool:
    """Metadata filter: callable, or a JMESPath-like `field == 'value'` /
    `contains(field, 'x')` string over a Json document (reference uses
    JMESPath, ``DerivedFilteredSearchIndex``)."""
    if flt is None:
        return True
    if callable(flt):
        try:
            return bool(flt(data))
        except Exception:  # noqa: BLE001
            return False
    from pathway_tpu_torch.internals.json import Json, unwrap_json

    doc = unwrap_json(data) if isinstance(data, Json) else data
    if not isinstance(flt, str) or doc is None:
        return False
    return _eval_jmespath_subset(flt, doc)


@functools.lru_cache(maxsize=256)
def _glob_regex(pattern: str):
    """Compile a path-aware glob: '*' and '?' do NOT cross '/', '**'
    matches zero or more whole components ('docs/**/*.md' matches
    'docs/readme.md'; fnmatch would let '*' cross into subdirectories)."""
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "*" and pattern[i : i + 2] == "**":
            if pattern[i : i + 3] == "**/":
                # '**/' absorbs its slash so zero components match
                out.append("(?:.*/)?")
                i += 3
            else:
                out.append(".*")
                i += 2
        elif c == "*":
            out.append("[^/]*")
            i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("".join(out))


def _glob_match(pattern: str, value: str) -> bool:
    return _glob_regex(pattern).fullmatch(value) is not None


def _eval_jmespath_subset(expr: str, doc: Any) -> bool:
    """Tiny JMESPath subset: `a.b == 'v'`, `a == `1``, contains(path, 'v'),
    conjunctions with &&, disjunctions with ||, negation with !."""
    expr = expr.strip()
    if "||" in expr:
        return any(_eval_jmespath_subset(p, doc) for p in expr.split("||"))
    if "&&" in expr:
        return all(_eval_jmespath_subset(p, doc) for p in expr.split("&&"))
    if expr.startswith("!"):
        return not _eval_jmespath_subset(expr[1:], doc)
    if expr.startswith("contains(") and expr.endswith(")"):
        inner = expr[len("contains(") : -1]
        path, _, raw = inner.partition(",")
        target = _parse_literal(raw.strip())
        value = _lookup(path.strip(), doc)
        try:
            return target in value
        except TypeError:
            return False
    if expr.startswith("glob(") and expr.endswith(")"):
        # the document store's filepath_globpattern compiles to
        # glob(path, '<pattern>') (reference uses a JMESPath glob fn)
        inner = expr[len("glob(") : -1]
        path, _, raw = inner.partition(",")
        pattern = _parse_literal(raw.strip())
        value = _lookup(path.strip(), doc)
        return (
            isinstance(value, str)
            and isinstance(pattern, str)
            and _glob_match(pattern, value)
        )
    for op in ("==", "!=", ">=", "<=", ">", "<"):
        if op in expr:
            lhs, rhs = expr.split(op, 1)
            value = _lookup(lhs.strip(), doc)
            target = _parse_literal(rhs.strip())
            try:
                if op == "==":
                    return value == target
                if op == "!=":
                    return value != target
                if op == ">=":
                    return value >= target
                if op == "<=":
                    return value <= target
                if op == ">":
                    return value > target
                return value < target
            except TypeError:
                return False
    value = _lookup(expr, doc)
    return bool(value)


def _lookup(path: str, doc: Any):
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


def _parse_literal(raw: str):
    raw = raw.strip()
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    if raw.startswith("`") and raw.endswith("`"):
        import json

        try:
            return json.loads(raw[1:-1])
        except json.JSONDecodeError:
            return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        try:
            return float(raw)
        except ValueError:
            return raw
