"""``pw.sql`` — SQL subset over tables (counterpart of
``pathway_tpu/internals/sql.py``).

The reference lowers a sqlglot-parsed subset (SELECT/WHERE/GROUP BY/HAVING/
JOIN/UNION/INTERSECT/WITH) onto Table ops (``internals/sql.py``). sqlglot is
not available in this environment, so this module implements a hand-rolled
parser for the same core subset; unsupported syntax raises NotImplementedError.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnExpression


_AGGS = {
    "count": reducers.count,
    "sum": reducers.sum,
    "min": reducers.min,
    "max": reducers.max,
    "avg": reducers.avg,
}


class _Tokenizer:
    _token_re = re.compile(
        r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<id>[A-Za-z_][A-Za-z_0-9.]*)"
        r"|(?P<str>'[^']*')|(?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\+|-|/|%))"
    )

    def __init__(self, text: str):
        self.tokens: list[str] = []
        pos = 0
        while pos < len(text):
            m = self._token_re.match(text, pos)
            if not m:
                if text[pos:].strip() == "":
                    break
                raise NotImplementedError(f"cannot tokenize SQL at: {text[pos:]!r}")
            self.tokens.append(m.group(0).strip())
            pos = m.end()
        self.i = 0

    def peek(self) -> str | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise NotImplementedError("unexpected end of SQL")
        self.i += 1
        return t

    def accept(self, *kw: str) -> bool:
        t = self.peek()
        if t is not None and t.upper() in kw:
            self.i += 1
            return True
        return False

    def expect(self, kw: str) -> None:
        if not self.accept(kw):
            raise NotImplementedError(f"expected {kw}, got {self.peek()!r}")


_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "AS", "AND", "OR",
    "NOT", "JOIN", "ON", "UNION", "INTERSECT", "EXCEPT", "WITH", "INNER",
    "LEFT", "RIGHT", "OUTER", "FULL", "NULL", "TRUE", "FALSE", "LIKE", "IN",
    "ALL",
}


def sql(query: str, **tables) -> Any:
    """Execute a SQL query over the given tables:

    >>> pw.sql("SELECT a, SUM(b) AS s FROM t GROUP BY a", t=my_table)
    """
    tk = _Tokenizer(query)
    tables = dict(tables)
    # WITH name AS ( select ) [, name2 AS ( select )] ... — CTEs become
    # additional named tables visible to the main select
    if tk.accept("WITH"):
        while True:
            name = tk.next()
            tk.expect("AS")
            tk.expect("(")
            tables[name] = _parse_select(tk, tables)
            tk.expect(")")
            if not tk.accept(","):
                break
    result = _parse_select(tk, tables)
    leftover = tk.peek()
    if leftover is not None:
        # silently ignoring a tail (e.g. an unsupported clause) would
        # return WRONG results that look plausible
        raise NotImplementedError(
            f"unsupported SQL from token {leftover!r}"
        )
    return result


def _parse_select(tk: _Tokenizer, tables: dict):
    """Set-operation chain with standard precedence: INTERSECT binds
    tighter than UNION/EXCEPT (which associate left)."""

    def intersect_chain():
        result = _parse_single_select(tk, tables)
        while tk.accept("INTERSECT"):
            result = _apply_set_op(
                result, "intersect", _parse_single_select(tk, tables)
            )
        return result

    result = intersect_chain()
    while True:
        if tk.accept("UNION"):
            kind = "union_all" if tk.accept("ALL") else "union"
            result = _apply_set_op(result, kind, intersect_chain())
        elif tk.accept("EXCEPT"):
            result = _apply_set_op(result, "except", intersect_chain())
        else:
            break
    return result


def _parse_single_select(tk: _Tokenizer, tables: dict):
    tk.expect("SELECT")
    # projections
    projections: list[tuple[str | None, Any]] = []  # (alias, raw expr fn)
    star = False
    while True:
        if tk.accept("*"):
            star = True
        else:
            e = _parse_expr(tk)
            alias = None
            if tk.accept("AS"):
                alias = tk.next()
            elif tk.peek() and tk.peek().upper() not in _KEYWORDS and tk.peek() not in (",",) and re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", tk.peek() or ""):
                alias = tk.next()
            projections.append((alias, e))
        if not tk.accept(","):
            break
    tk.expect("FROM")
    tname = tk.next()
    if tname not in tables:
        raise ValueError(f"unknown table {tname!r} in SQL")
    table = tables[tname]
    # JOIN
    while tk.peek() and tk.peek().upper() in ("JOIN", "INNER", "LEFT", "RIGHT", "FULL"):
        how = "inner"
        t = tk.next().upper()
        if t in ("LEFT", "RIGHT"):
            how = t.lower()
            tk.accept("OUTER")
            tk.expect("JOIN")
        elif t == "FULL":
            how = "outer"
            tk.accept("OUTER")
            tk.expect("JOIN")
        elif t == "INNER":
            tk.expect("JOIN")
        other_name = tk.next()
        other = tables[other_name]
        tk.expect("ON")
        cond = _parse_condition(tk)
        lcol, rcol = cond
        l_expr = _resolve_col(lcol, {tname: table, other_name: other})
        r_expr = _resolve_col(rcol, {tname: table, other_name: other})
        table = _join_select(table, other, l_expr, r_expr, how)
    where_expr = None
    if tk.accept("WHERE"):
        where_expr = _parse_bool_expr(tk)
    group_cols: list[str] = []
    if tk.accept("GROUP"):
        tk.expect("BY")
        while True:
            group_cols.append(tk.next())
            if not tk.accept(","):
                break
    having = None
    if tk.accept("HAVING"):
        having = _parse_bool_expr(tk)
    # UNION / INTERSECT

    # build
    if where_expr is not None:
        table = table.filter(_materialize(where_expr, table))
    if group_cols:
        grouped = table.groupby(*[table[c] for c in group_cols])
        sel = {}
        for alias, e in projections:
            name = alias or _default_name(e)
            sel[name] = _materialize(e, table)
        hidden: list[str] = []
        if having is not None:
            ast_to_name = {
                repr(e): (alias or _default_name(e))
                for alias, e in projections
            }
            # aggregates inside HAVING evaluate in the reduce, not on the
            # reduced table: reuse a projection alias when the identical
            # aggregate is already projected, otherwise add a hidden column
            def lift(ast):
                if not isinstance(ast, tuple):
                    return ast
                if ast[0] == "agg":
                    name = ast_to_name.get(repr(ast))
                    if name is None:
                        name = f"__having_{len(hidden)}"
                        hidden.append(name)
                        sel[name] = _materialize(ast, table)
                        ast_to_name[repr(ast)] = name
                    return ("col", name)
                return tuple(lift(a) for a in ast)

            having = lift(having)
        result = grouped.reduce(**sel)
        if having is not None:
            result = result.filter(_materialize(having, result))
            if hidden:
                result = result.without(*hidden)
    elif star:
        if having is not None:
            raise NotImplementedError(
                "HAVING requires GROUP BY (use WHERE for row filters)"
            )
        result = table
    else:
        if having is not None:
            raise NotImplementedError(
                "HAVING requires GROUP BY (use WHERE for row filters)"
            )
        sel = {}
        for alias, e in projections:
            name = alias or _default_name(e)
            sel[name] = _materialize(e, table)

        def has_agg(ast):
            if not isinstance(ast, tuple):
                return False
            if ast[0] == "agg":
                return True
            return any(has_agg(a) for a in ast)

        if any(has_agg(e) for _alias, e in projections):
            # global aggregate (SELECT COUNT(*) FROM t without GROUP BY)
            result = table.reduce(**sel)
        else:
            result = table.select(**sel)
    return result


def _distinct_by_content(t):
    """Content-keyed distinct rows: groupby on every column both dedups and
    keys the output by row content, so equal rows on the two sides of a set
    op share a key."""
    cols = t.column_names()
    return t.groupby(*[t[c] for c in cols]).reduce(*[t[c] for c in cols])


def _apply_set_op(result, kind: str, other):
    """SQL set semantics: by ROW CONTENT with dedup (except UNION ALL)."""
    cols = result.column_names()
    if other.column_names() != cols:
        raise ValueError(
            f"set operation column mismatch: {cols} vs {other.column_names()}"
        )
    if kind == "union_all":
        return result.concat_reindex(other)
    left = _distinct_by_content(result)
    right = _distinct_by_content(other)
    if kind == "union":
        return left.update_rows(right)
    if kind == "except":
        return left.difference(right)
    return left.intersect(right)


def _resolve_col(name: str, tables_by_name: dict):
    if "." in name:
        tn, cn = name.split(".", 1)
        return tables_by_name[tn][cn]
    for t in tables_by_name.values():
        if name in t.column_names():
            return t[name]
    raise ValueError(f"unknown column {name!r} in SQL join condition")


def _join_select(left, right, l_expr, r_expr, how):
    from pathway_tpu_torch.internals import thisclass

    joined = left.join(right, l_expr == r_expr, how=how)
    cols = {}
    for n in left.column_names():
        cols[n] = expr_mod.ColumnReference(thisclass.left, n)
    for n in right.column_names():
        if n not in cols:
            cols[n] = expr_mod.ColumnReference(thisclass.right, n)
    return joined.select(**cols)


# --- tiny expression AST: tuples ("col", name) / ("lit", v) / ("bin", op, l, r)
# / ("agg", fname, arg) / ("not", e)


def _parse_expr(tk: _Tokenizer):
    return _parse_additive(tk)


def _parse_additive(tk):
    left = _parse_multiplicative(tk)
    while tk.peek() in ("+", "-"):
        op = tk.next()
        right = _parse_multiplicative(tk)
        left = ("bin", op, left, right)
    return left


def _parse_multiplicative(tk):
    left = _parse_atom(tk)
    while tk.peek() in ("*", "/", "%"):
        op = tk.next()
        right = _parse_atom(tk)
        left = ("bin", op, left, right)
    return left


def _parse_atom(tk):
    t = tk.peek()
    if t == "(":
        tk.next()
        e = _parse_expr(tk)
        tk.expect(")")
        return e
    t = tk.next()
    if re.fullmatch(r"\d+", t):
        return ("lit", int(t))
    if re.fullmatch(r"\d+\.\d+", t):
        return ("lit", float(t))
    if t.startswith("'"):
        return ("lit", t[1:-1])
    up = t.upper()
    if up == "NULL":
        return ("lit", None)
    if up == "TRUE":
        return ("lit", True)
    if up == "FALSE":
        return ("lit", False)
    if up.lower() in _AGGS and tk.peek() == "(":
        tk.next()
        if tk.peek() == "*":
            tk.next()
            tk.expect(")")
            return ("agg", up.lower(), None)
        arg = _parse_expr(tk)
        tk.expect(")")
        return ("agg", up.lower(), arg)
    return ("col", t)


def _parse_condition(tk):
    l = tk.next()
    tk.expect("=")
    r = tk.next()
    return (l, r)


def _parse_bool_expr(tk):
    left = _parse_bool_term(tk)
    while tk.accept("OR"):
        right = _parse_bool_term(tk)
        left = ("bin", "OR", left, right)
    return left


def _parse_bool_term(tk):
    left = _parse_bool_factor(tk)
    while tk.accept("AND"):
        right = _parse_bool_factor(tk)
        left = ("bin", "AND", left, right)
    return left


def _parse_bool_factor(tk):
    if tk.accept("NOT"):
        return ("not", _parse_bool_factor(tk))
    left = _parse_expr(tk)
    t = tk.peek()
    if t in ("=", "<>", "!=", "<", "<=", ">", ">="):
        op = tk.next()
        right = _parse_expr(tk)
        return ("bin", op, left, right)
    return left


_BIN_MAP = {
    "=": "==",
    "<>": "!=",
    "!=": "!=",
    "<": "<",
    "<=": "<=",
    ">": ">",
    ">=": ">=",
    "+": "+",
    "-": "-",
    "*": "*",
    "/": "/",
    "%": "%",
}


def _materialize(ast, table) -> ColumnExpression:
    kind = ast[0]
    if kind == "lit":
        return expr_mod.ColumnConstExpression(ast[1])
    if kind == "col":
        name = ast[1]
        if "." in name:
            name = name.split(".")[-1]
        return table[name]
    if kind == "bin":
        op = ast[1].upper()
        l = _materialize(ast[2], table)
        r = _materialize(ast[3], table)
        if op == "AND":
            return l & r
        if op == "OR":
            return l | r
        return expr_mod.ColumnBinaryOpExpression(l, r, _BIN_MAP[ast[1]])
    if kind == "not":
        return ~_materialize(ast[1], table)
    if kind == "agg":
        fname = ast[1]
        if ast[2] is None:
            return reducers.count()
        return _AGGS[fname](_materialize(ast[2], table))
    raise NotImplementedError(f"SQL node {ast!r}")


def _default_name(ast) -> str:
    if ast[0] == "col":
        return ast[1].split(".")[-1]
    if ast[0] == "agg":
        return ast[1]
    return "expr"
