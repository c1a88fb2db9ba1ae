"""``pw.io.subscribe`` (reference ``python/pathway/io/_subscribe.py``)."""

from __future__ import annotations

from typing import Callable

from pathway_tpu_torch.engine.operators.output import SubscribeNode
from pathway_tpu_torch.internals.parse_graph import G


def subscribe(
    table,
    on_change: Callable | None = None,
    on_end: Callable | None = None,
    on_time_end: Callable | None = None,
    *,
    skip_errors: bool = True,
    name: str | None = None,
):
    """Call ``on_change(key, row, time, is_addition)`` for every delta."""

    def wrapped_on_change(key, row, time, is_addition):
        if on_change is not None:
            on_change(key=key, row=row, time=time, is_addition=is_addition)

    node = SubscribeNode(
        G.engine_graph,
        table._node,
        on_change=wrapped_on_change if on_change is not None else None,
        on_time_end=on_time_end,
        on_end=on_end,
        skip_errors=skip_errors,
    )
    G.register_sink(node)
    return node
