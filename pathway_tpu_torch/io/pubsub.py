"""Google Pub/Sub sink (reference ``python/pathway/io/pubsub/__init__.py:49``:
single binary-column table published per change with ``pathway_time`` /
``pathway_diff`` attributes)."""

from __future__ import annotations

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def write(table: Table, publisher, project_id: str, topic_id: str) -> None:
    """Publish each change of the single binary column of ``table`` to the
    topic. ``publisher`` is duck-typed (``topic_path`` + ``publish``) — a
    ``pubsub_v1.PublisherClient`` or any test double."""
    cols = table.column_names()
    if len(cols) != 1:
        raise ValueError(
            "pw.io.pubsub.write expects a table with exactly one (binary) "
            f"column, got {cols}"
        )
    topic_path = publisher.topic_path(project_id, topic_id)

    def write_batch(time, batch):
        futures = []
        for _key, row, diff in batch.rows():
            value = row[0]
            if isinstance(value, str):
                value = value.encode()
            if not isinstance(value, (bytes, bytearray)):
                raise ValueError(
                    "pw.io.pubsub.write requires a binary column; got "
                    f"{type(value).__name__}"
                )
            futures.append(
                publisher.publish(
                    topic_path,
                    bytes(value),
                    pathway_time=str(time),
                    pathway_diff=str(diff),
                )
            )
        # drain the batch's futures so publish failures surface in the run
        # and nothing accumulates across the stream's lifetime
        for f in futures:
            result = getattr(f, "result", None)
            if result is not None:
                result(timeout=60)

    node = SinkNode(
        G.engine_graph, table._node, write_batch, name=f"pubsub({topic_id})"
    )
    G.register_sink(node)
