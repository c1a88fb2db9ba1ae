"""``@pw.pandas_transformer`` (counterpart of
``pathway_tpu/stdlib/utils/pandas_transformer.py``):
run a pandas DataFrame function over full tables, re-entering the dataflow.
Executes per epoch end via capture + static rebuild (batch semantics)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals import schema as schema_mod


def pandas_transformer(output_schema: Any, output_universe: Any | None = None):
    def decorator(fun: Callable):
        def wrapper(*tables):
            from pathway_tpu_torch.debug import table_from_pandas, table_to_pandas

            dfs = [table_to_pandas(t, include_id=False) for t in tables]
            out = fun(*dfs)
            out.columns = list(output_schema.column_names())
            return table_from_pandas(out, schema=output_schema)

        return wrapper

    return decorator
