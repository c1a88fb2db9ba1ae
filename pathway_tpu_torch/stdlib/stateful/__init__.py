"""Stateful operations (reference ``stdlib/stateful/deduplicate.py``)."""

from __future__ import annotations

from typing import Any, Callable


def deduplicate(
    table,
    *,
    value,
    instance=None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
):
    """Keep the previously accepted value per instance unless ``acceptor(new,
    old)`` approves a change."""
    return table.deduplicate(value=value, instance=instance, acceptor=acceptor)
