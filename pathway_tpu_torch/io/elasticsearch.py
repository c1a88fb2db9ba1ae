"""Elasticsearch sink (reference ``python/pathway/io/elasticsearch``;
engine ``ElasticSearchWriter`` data_storage.rs:1336). Gated on the
``elasticsearch`` client package."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._utils import format_value_for_output


class ElasticSearchAuth:
    """Auth holder mirroring the reference's ``ElasticSearchAuth``."""

    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.kwargs = kwargs

    @classmethod
    def apikey(cls, apikey_id, apikey):
        return cls("apikey", api_key=(apikey_id, apikey))

    @classmethod
    def basic(cls, username, password):
        return cls("basic", basic_auth=(username, password))

    @classmethod
    def bearer(cls, bearer):
        return cls("bearer", bearer_auth=bearer)


def write(table, host: str, auth: ElasticSearchAuth | None = None,
          index_name: str = "", *, _client=None, **kwargs) -> None:
    """``_client`` (Elasticsearch-shaped ``.index(index=, document=)``) is
    injectable for offline tests."""
    if _client is None:
        try:
            from elasticsearch import Elasticsearch
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("pw.io.elasticsearch requires the `elasticsearch` package") from exc
        _client = Elasticsearch(host, **(auth.kwargs if auth else {}))
    client = _client
    cols = list(table.column_names())

    def write_batch(time, batch):
        for _key, row, diff in batch.rows():
            if diff <= 0:
                continue
            doc = {c: format_value_for_output(v) for c, v in zip(cols, row)}
            client.index(index=index_name, document=doc)

    node = SinkNode(G.engine_graph, table._node, write_batch, name=f"es({index_name})")
    G.register_sink(node)
