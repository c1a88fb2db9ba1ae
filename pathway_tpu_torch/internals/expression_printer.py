"""Human-readable expression rendering (reference
``internals/expression_printer.py``): used by error messages to show which
expression failed and where it was defined."""

from __future__ import annotations

import io

from pathway_tpu_torch.internals import expression as expr_mod


class ExpressionFormatter:
    """Pretty-prints a ColumnExpression, numbering the tables it touches."""

    def __init__(self):
        self._tables: list = []

    def table_number(self, table) -> int:
        for i, t in enumerate(self._tables):
            if t is table:
                return i + 1
        self._tables.append(table)
        return len(self._tables)

    def print_table_infos(self) -> str:
        out = io.StringIO()
        for i, t in enumerate(self._tables):
            cols = ", ".join(t.column_names()) if hasattr(t, "column_names") else "?"
            print(f"<table{i + 1}>: columns [{cols}]", file=out)
        return out.getvalue()

    def eval(self, e) -> str:
        if isinstance(e, expr_mod.ColumnReference):
            t = e._table
            if t is None:
                return f"<col>.{e._name}"
            return f"<table{self.table_number(t)}>.{e._name}"
        if isinstance(e, expr_mod.ColumnConstExpression):
            return repr(e._value)
        if isinstance(e, expr_mod.ColumnBinaryOpExpression):
            return f"({self.eval(e._left)} {e._operator} {self.eval(e._right)})"
        deps = ", ".join(self.eval(d) for d in e._deps())
        return f"{type(e).__name__.removesuffix('Expression').lower()}({deps})"


def get_expression_info(expression) -> str:
    """One-line description of an expression plus the tables it references."""
    printer = ExpressionFormatter()
    rendered = printer.eval(expression)
    tables = printer.print_table_infos()
    if tables:
        return f"{rendered}\nwhere:\n{tables}"
    return rendered
