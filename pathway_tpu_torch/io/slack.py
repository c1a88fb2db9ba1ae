"""Slack alert sink (reference ``python/pathway/io/slack/__init__.py:11``:
``send_alerts`` posts each value of a column to a channel via
``chat.postMessage``)."""

from __future__ import annotations

import json

from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.parse_graph import G

_SLACK_URL = "https://slack.com/api/chat.postMessage"


def _default_sender(slack_token: str):
    import urllib.request

    def send(payload: dict) -> None:
        req = urllib.request.Request(
            _SLACK_URL,
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {slack_token}",
            },
            method="POST",
        )
        urllib.request.urlopen(req, timeout=30)

    return send


def send_alerts(
    alerts: ColumnReference,
    slack_channel_id: str,
    slack_token: str,
    *,
    _sender=None,
) -> None:
    """Post every added value of the ``alerts`` column as a Slack message.
    ``_sender(payload_dict)`` is injectable for offline tests."""
    table = alerts._table.select(_alert=alerts)
    sender = _sender or _default_sender(slack_token)

    def write_batch(time, batch):
        for _key, row, diff in batch.rows():
            if diff <= 0:
                continue
            sender({"channel": slack_channel_id, "text": str(row[0])})

    node = SinkNode(
        G.engine_graph, table._node, write_batch,
        name=f"slack({slack_channel_id})",
    )
    G.register_sink(node)
