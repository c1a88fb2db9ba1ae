"""MongoDB sink (reference ``python/pathway/io/mongodb``; engine
``MongoWriter`` data_storage.rs:2232, ``BsonFormatter``). Gated on
``pymongo``."""

from __future__ import annotations

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._utils import format_value_for_output


def write(table, connection_string: str, database: str, collection: str,
          *, max_batch_size: int | None = None, _client=None, **kwargs) -> None:
    """``_client`` (pymongo-shaped ``client[db][coll].insert_many``) is
    injectable for offline tests, like the gdrive/sharepoint connectors."""
    if _client is None:
        try:
            import pymongo
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("pw.io.mongodb requires the `pymongo` package") from exc
        _client = pymongo.MongoClient(connection_string)
    coll = _client[database][collection]
    cols = list(table.column_names())

    def write_batch(time, batch):
        docs = []
        for _key, row, diff in batch.rows():
            doc = {c: format_value_for_output(v) for c, v in zip(cols, row)}
            doc["time"] = time
            doc["diff"] = diff
            docs.append(doc)
        # chunk inserts: one giant insert_many can exceed Mongo's message
        # size limits and fail the whole batch
        chunk = max_batch_size or len(docs) or 1
        for start in range(0, len(docs), chunk):
            coll.insert_many(docs[start : start + chunk])

    node = SinkNode(G.engine_graph, table._node, write_batch, name=f"mongodb({collection})")
    G.register_sink(node)
