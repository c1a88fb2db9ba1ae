"""``pw.demo`` — synthetic stream generators (counterpart of
``pathway_tpu/demo/``; reference ``python/pathway/demo/``).

``range_stream``, ``noisy_linear_stream``, ``generate_custom_stream``,
``replay_csv`` (+ ``replay_csv_with_time``) — streaming inputs for examples
and tests, on the port's ``BaseConnector``: each generated row is one commit
at a fresh engine time, as in JAX, paced at ``input_rate`` rows a second
(``input_rate=0``: as fast as the engine takes them).
"""

from __future__ import annotations

import csv
import time as time_mod
from typing import Any, Callable, Mapping

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.value import hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector


class _GeneratorConnector(BaseConnector):
    def __init__(self, node, gen_rows: Callable, input_rate: float, autocommit_ms: int | None):
        super().__init__(node)
        self.gen_rows = gen_rows
        self.input_rate = input_rate

    def run(self):
        for key, row in self.gen_rows():
            if self.should_stop():
                return
            self.commit_rows([(key, row, 1)])
            if self.input_rate > 0:
                time_mod.sleep(1.0 / self.input_rate)


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema,
    nb_rows: int | None = None,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_id: str | None = None,
    name: str | None = None,
) -> Table:
    cols = list(schema.column_names())
    node = InputNode(G.engine_graph, cols, name="DemoStream")

    def gen_rows():
        i = 0
        while nb_rows is None or i < nb_rows:
            values = {c: value_generators[c](i) for c in cols}
            pk = schema.primary_key_columns()
            key = (
                hash_values(*[values[c] for c in pk]) if pk else hash_values(i)
            )
            yield key, tuple(values[c] for c in cols)
            i += 1

    conn = _GeneratorConnector(node, gen_rows, input_rate, autocommit_duration_ms)
    G.register_connector(conn)
    return Table(node, schema, Universe())


def range_stream(
    nb_rows: int = 30,
    offset: int = 0,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 1000,
    **kwargs,
) -> Table:
    schema = schema_mod.schema_from_types(value=int)
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def noisy_linear_stream(
    nb_rows: int = 10, input_rate: float = 1.0, **kwargs
) -> Table:
    import random

    schema = schema_mod.schema_from_types(x=float, y=float)
    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + random.uniform(-1, 1),
        },
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def replay_csv(
    path: str,
    *,
    schema,
    input_rate: float = 1.0,
) -> Table:
    cols = list(schema.column_names())
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
    node = InputNode(G.engine_graph, cols, name="ReplayCsv")

    def gen_rows():
        with open(path, newline="") as f:
            for i, record in enumerate(csv.DictReader(f)):
                values = {}
                for c in cols:
                    v = record[c]
                    d = dtypes[c]
                    if d is dt.INT:
                        v = int(v)
                    elif d is dt.FLOAT:
                        v = float(v)
                    elif d is dt.BOOL:
                        v = v.lower() in ("1", "true", "yes")
                    values[c] = v
                pk = schema.primary_key_columns()
                key = hash_values(*[values[c] for c in pk]) if pk else hash_values(i)
                yield key, tuple(values[c] for c in cols)

    conn = _GeneratorConnector(node, gen_rows, input_rate, None)
    G.register_connector(conn)
    return Table(node, schema, Universe())


def replay_csv_with_time(
    path: str,
    *,
    schema,
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1,
) -> Table:
    return replay_csv(path, schema=schema, input_rate=0)
