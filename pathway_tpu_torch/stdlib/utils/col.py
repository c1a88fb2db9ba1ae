"""Column manipulation helpers (counterpart of ``pathway_tpu/stdlib/utils/col.py``,
reference ``stdlib/utils/col.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference


def unpack_col(column, *unpacked_columns, schema=None):
    """Expand a tuple column into separate columns."""
    table = column.table
    if schema is not None:
        names = list(schema.column_names())
    else:
        names = [
            c.name if isinstance(c, ColumnReference) else c
            for c in unpacked_columns
        ]
    from pathway_tpu_torch.internals import expression as expr_mod

    exprs = {
        name: expr_mod.GetExpression(column, i, check_if_exists=False)
        for i, name in enumerate(names)
    }
    return table.select(**exprs)


def flatten_column(column, origin_id="origin_id"):
    """Deprecated alias for ``Table.flatten`` (reference ``col.py:16``)."""
    import warnings

    warnings.warn(
        "utils.col.flatten_column() is deprecated, use Table.flatten() instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return column.table.flatten(column, origin_id=origin_id)


def unpack_col_dict(column, schema):
    """Unpack a Json-object column into typed columns given by ``schema``
    (reference ``col.py:143``).  Missing keys become None; non-optional
    columns are unwrapped."""
    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals import expression as expr_mod

    table = column.table
    typehints = schema._dtypes()

    def convert(name):
        target = typehints[name]
        is_optional = target.is_optional()
        inner = target.strip_optional()
        col = expr_mod.GetExpression(column, name, default=None, check_if_exists=True)
        # Json payloads in this engine hold plain Python scalars, so no
        # as_int/as_float coercion chain is needed; float columns may still
        # arrive as Json ints.
        if inner == dt.FLOAT:
            col = expr_mod.apply_with_type(
                lambda v: None if v is None else float(v), target, col
            )
        if not is_optional:
            col = expr_mod.unwrap(col)
        return col

    result = table.select(**{n: convert(n) for n in schema.column_names()})
    return result.update_types(**{n: typehints[n] for n in schema.column_names()})


def multiapply_all_rows(*cols, fun, result_col_names):
    """Apply ``fun`` to entire columns at once (all rows gathered into one
    state), returning several result columns re-keyed to the original rows.
    Reference ``col.py:multiapply_all_rows``; meant for small tables."""
    from pathway_tpu_torch.internals import expression as expr_mod
    from pathway_tpu_torch.internals import reducers

    assert len(cols) > 0
    table = cols[0].table
    n_cols = len(cols)
    names = [
        c.name if isinstance(c, ColumnReference) else c for c in result_col_names
    ]

    packed = table.select(
        packed=expr_mod.apply(lambda *a: tuple(a), table.id, *cols)
    )
    reduced = packed.reduce(rows=reducers.sorted_tuple(packed.packed))

    def fun_wrapped(rows):
        ids = [r[0] for r in rows]
        col_lists = [[r[i + 1] for r in rows] for i in range(n_cols)]
        results = fun(*col_lists)
        return [
            (ids[j], *[results[m][j] for m in range(len(names))])
            for j in range(len(ids))
        ]

    out = reduced.select(out=expr_mod.apply(fun_wrapped, reduced.rows))
    flat = out.flatten(out.out)
    keyed = flat.select(
        _pw_key=expr_mod.GetExpression(flat.out, 0, check_if_exists=False),
        **{
            name: expr_mod.GetExpression(flat.out, i + 1, check_if_exists=False)
            for i, name in enumerate(names)
        },
    )
    return keyed.with_id(keyed["_pw_key"]).without("_pw_key")


def apply_all_rows(*cols, fun, result_col_name):
    """Single-output-column variant of ``multiapply_all_rows``: ``fun``
    returns ONE list of per-row results (reference ``col.py:apply_all_rows``)."""
    return multiapply_all_rows(
        *cols, fun=lambda *col_lists: (fun(*col_lists),),
        result_col_names=[result_col_name]
    )


def groupby_reduce_majority(column, votes_column):
    """Per-group majority vote: groups rows by ``column`` and reduces
    ``votes_column`` to its most frequent value in column ``majority``
    (reference ``col.py:groupby_reduce_majority``)."""
    from collections import Counter

    from pathway_tpu_torch.internals import dtype as dt
    from pathway_tpu_torch.internals import expression as expr_mod
    from pathway_tpu_torch.internals import reducers

    table = column.table
    return table.groupby(column).reduce(
        column,
        majority=expr_mod.apply_with_type(
            lambda vs: Counter(vs).most_common(1)[0][0],
            dt.ANY,
            reducers.tuple(votes_column),
        ),
    )
