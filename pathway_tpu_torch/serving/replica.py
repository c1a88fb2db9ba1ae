"""In-process fleet replica (counterpart of ``InProcessReplica`` and
``ReplicaError`` in ``pathway_tpu/serving/replica.py``).

A replica is a duck type: ``replica_id``, ``submit``, ``healthy()``,
``occupancy()``, ``scrape()``, ``stop()``. It owns no ring membership and
no metrics (the router's and the manager's), so it can be built, probed
and torn down alone. The JAX package's ``HttpReplica`` and
``spawn_replica_process`` forward to a replica's REST routes, which the
port does not have yet.
"""

from __future__ import annotations

from pathway_tpu_torch.engine import slo


class ReplicaError(RuntimeError):
    """A replica could not accept or complete a request (a dead serving
    loop, no candidate left)."""


class InProcessReplica:
    """A ``DecoderChat(continuous=True)`` of this process as a fleet
    member. Several may share one card: each server issues its work from
    its own thread, in order, on the card's current stream."""

    kind = "inproc"

    def __init__(self, replica_id: str, chat) -> None:
        self.replica_id = replica_id
        self.chat = chat

    def submit(self, prompt, max_new: int | None = None, *, priority: int = 1):
        """Enqueue one prompt; returns the server's pending completion
        (``done``, ``text``, ``tokens``, ``error_reason``). A dead or
        stopped serving loop raises :class:`ReplicaError`."""
        kwargs: dict = {"priority": priority}
        if max_new is not None:
            kwargs["max_new_tokens"] = int(max_new)
        try:
            return self.chat.submit_batch([prompt], **kwargs)[0]
        except RuntimeError as exc:
            raise ReplicaError(str(exc)) from exc

    def healthy(self) -> bool:
        srv = self.chat.server
        return srv is not None and srv.failed is None and srv.thread.is_alive()

    def occupancy(self) -> float:
        srv = self.chat.server
        return srv.occupancy() if srv is not None else 0.0

    def scrape(self) -> dict:
        """Statistics in the shape the fleet manager reads: the server's
        counters, lanes and tenant depths, and the SLO watchdog's state."""
        srv = self.chat.server
        return {
            "server": dict(srv.stats) if srv is not None else {},
            "lanes": srv.lane_stats() if srv is not None else {},
            "tenants": srv.tenant_depths() if srv is not None else {},
            "slo": slo.slo_snapshot(),
        }

    def stop(self) -> None:
        self.chat.close()
