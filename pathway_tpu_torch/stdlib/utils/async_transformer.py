"""AsyncTransformer — fully-async row→row transformation with its own output
universe (counterpart of ``pathway_tpu/stdlib/utils/async_transformer.py``,
reference ``stdlib/utils/async_transformer.py:282``): invoke() runs per row
on the engine's async runtime (``engine/async_runtime.py``); a failed row's
outputs are ``ERROR`` values, filtered out of ``.successful`` and kept in
``.failed`` (as None) and ``.finished``.
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import Any, ClassVar

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table


class ResultType(enum.Enum):
    """Row outcome of an async transformer invocation (reference
    ``async_transformer.py:ResultType``)."""

    SUCCESS = "success"
    FAILURE = "failure"


class AsyncTransformer(ABC):
    output_schema: ClassVar[Any]

    def __init_subclass__(cls, /, output_schema=None, **kwargs):
        # reference API: class X(pw.AsyncTransformer, output_schema=Schema)
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(self, input_table: Table, instance=None, **kwargs):
        self._input_table = input_table
        self._instance = instance

    @abstractmethod
    async def invoke(self, *args, **kwargs) -> dict: ...

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    @property
    def successful(self) -> Table:
        return self.result

    @property
    def failed(self) -> Table:
        result = self._full_result()
        # rows whose outputs errored: the apply propagates ERROR, fill_error
        # turns it into True; clean rows evaluate to False and are dropped
        cond = expr_mod.fill_error(
            expr_mod.apply_with_type(
                lambda *vals: False, bool, *[result[n] for n in result.column_names()]
            ),
            True,
        )
        failed = result.filter(cond)
        # the error outputs themselves are unusable values — surface them
        # as None so the failed table can flow into sinks/joins (matching
        # the reference's consumable failure diagnostics)
        return failed.select(
            **{
                n: expr_mod.fill_error(failed[n], None)
                for n in result.column_names()
            }
        )

    @property
    def finished(self) -> Table:
        return self._full_result()

    _cached: Table | None = None

    def _full_result(self) -> Table:
        if self._cached is not None:
            return self._cached
        self.open()
        schema = self.output_schema
        cols = list(self._input_table.column_names())
        out_cols = list(schema.column_names())
        transformer = self

        async def call(*vals):
            kwargs = dict(zip(cols, vals))
            result = await transformer.invoke(**kwargs)
            return tuple(result.get(c) for c in out_cols)

        tuple_expr = expr_mod.AsyncApplyExpression(
            call,
            dt.ANY_TUPLE,
            args=tuple(self._input_table[c] for c in cols),
        )
        packed = self._input_table.select(__packed=tuple_expr)
        exprs = {
            name: expr_mod.GetExpression(
                packed["__packed"], i, check_if_exists=False
            )
            for i, name in enumerate(out_cols)
        }
        result = packed.select(**exprs)
        result = Table(
            result._node,
            schema_mod.schema_builder_from_definitions(
                {
                    n: schema_mod.ColumnDefinition(
                        dtype=schema.__columns__[n].dtype, name=n
                    )
                    for n in out_cols
                }
            ),
            result._universe,
        )
        self._cached = result
        return result

    @property
    def result(self) -> Table:
        result = self._full_result()
        cond = expr_mod.fill_error(
            expr_mod.apply_with_type(
                lambda *vals: True, bool, *[result[n] for n in result.column_names()]
            ),
            False,
        )
        return result.filter(cond)

    def with_options(self, **kwargs) -> "AsyncTransformer":
        return self
