"""Engine operator for ``@pw.transformer`` row transformers (counterpart of
``pathway_tpu/engine/operators/row_transformer.py``).

The reference executes these through engine "complex columns" with a
per-row ``Computer`` (``src/engine/graph.rs:277-378``) that lazily resolves
attribute dependencies. Here the operator materialises the transformer's
input tables (StatefulNode) and, on any change, re-evaluates the affected
class-arg's output attributes for every resident row with a shared memo —
emitting only the delta vs the previously emitted rows.
"""

from __future__ import annotations

from pathway_tpu_torch.engine.operators.core import StatefulNode, diff_tables
from pathway_tpu_torch.engine.value import ERROR
from pathway_tpu_torch.internals.errors import get_global_error_log


class RowTransformerNode(StatefulNode):
    """One output table of a row transformer (all input tables are inputs)."""

    _state_attrs = ("_in_states", "_emitted")

    def __init__(self, graph, input_nodes, spec, arg_names, arg_name,
                 out_columns, input_positions, name=""):
        """out_columns: list of (output_column_name, attribute_name);
        input_positions: per-wiring {arg_name: {input_attr: column index}}."""
        super().__init__(graph, input_nodes, [c for c, _ in out_columns], name)
        self.spec = spec
        self.arg_names = arg_names
        self.arg_name = arg_name
        self.out_attr_names = [a for _, a in out_columns]
        self.input_positions = input_positions
        self._emitted: dict[int, tuple] = {}

    def reset(self):
        super().reset()
        self._emitted = {}

    def _make_evaluator(self):
        from pathway_tpu_torch.internals.row_transformer import _Evaluator

        states = dict(zip(self.arg_names, self._in_states))
        return _Evaluator(self.spec, states, self.input_positions,
                          self._make_evaluator)

    def step(self, time, ins):
        changed = False
        for st, batch in zip(self._in_states, ins):
            if batch is None or len(batch) == 0:
                continue
            st.apply(batch)
            changed = True
        if not changed:
            return None

        ev = self._make_evaluator()
        my_state = self._in_states[self.arg_names.index(self.arg_name)]
        new_rows: dict[int, tuple] = {}
        for key in my_state.rows:
            vals = []
            for attr_name in self.out_attr_names:
                try:
                    vals.append(ev.value(self.arg_name, key, attr_name))
                except Exception as e:  # noqa: BLE001 - user code may raise
                    get_global_error_log().log(
                        f"transformer attribute "
                        f"{self.arg_name}.{attr_name}: {e!r}",
                        operator=self.name,
                    )
                    vals.append(ERROR)
            new_rows[key] = tuple(vals)
        out = diff_tables(self._emitted, new_rows, self.column_names)
        self._emitted = new_rows
        return out
