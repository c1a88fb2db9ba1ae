"""Replica handles for the fleet router and supervisor (counterpart of
``pathway_tpu/serving/replica.py``).

Two shapes behind one duck type (``replica_id``, ``healthy()``,
``scrape()``, ``stop()``):

* :class:`InProcessReplica`: a continuous ``DecoderChat`` of this
  process, reached through ``submit``;
* :class:`HttpReplica`: a process of its own reached over HTTP, spawned by
  :func:`spawn_replica_process` as a single-process run on its own port.
  Health is the ``/healthz`` (liveness) and ``/readyz`` (pipeline started)
  pair every REST server answers; request bodies go to it verbatim through
  :meth:`HttpReplica.forward`, which ``RouterServer`` calls.

Neither owns ring membership or metrics (the router's and the manager's),
so a replica can be built, probed and torn down alone.
"""

from __future__ import annotations

import http.client
import json
import socket
import subprocess
import urllib.error
import urllib.request

from pathway_tpu_torch.engine import slo
from pathway_tpu_torch.internals.config import environ_snapshot


class ReplicaError(RuntimeError):
    """A replica could not accept or complete a request (a dead serving
    loop, no candidate left)."""


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port the OS assigns, released at once: the usual
    bind(0) race, acceptable for spawning local replicas."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_replica_process(argv: list, *, replica_index: int, port: int, run_id: str,
                          env: dict | None = None, **popen_kw) -> subprocess.Popen:
    """Start ``argv`` as one replica: its own single-process run
    (``PATHWAY_PROCESSES=1``) on its own first port, sharing only the run
    id, the environment contract the JAX package hands its replicas. The
    library reads none of these variables: the child's program builds its
    ``EngineConfig`` from what it was given (the CLI also passes ``--port``
    on its command line). ``env`` replaces this process's environment as
    the base; ``popen_kw`` go to ``subprocess.Popen`` (e.g. ``stderr=``)."""
    child = environ_snapshot() if env is None else dict(env)
    child["PATHWAY_THREADS"] = "1"
    child["PATHWAY_PROCESSES"] = "1"
    child["PATHWAY_PROCESS_ID"] = str(int(replica_index))
    child["PATHWAY_FIRST_PORT"] = str(int(port))
    child["PATHWAY_RUN_ID"] = run_id
    return subprocess.Popen(list(argv), env=child, **popen_kw)


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


class HttpReplica:
    """A replica process reached over HTTP at ``base_url``."""

    kind = "http"

    def __init__(self, replica_id: str, base_url: str, *,
                 proc: subprocess.Popen | None = None, probe_timeout_s: float = 2.0) -> None:
        self.replica_id = replica_id
        self.base_url = base_url.rstrip("/")
        self.proc = proc
        self.probe_timeout_s = float(probe_timeout_s)

    def _get(self, route: str, timeout: float) -> tuple[int, bytes]:
        req = urllib.request.Request(self.base_url + route, method="GET")
        with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
            return resp.status, resp.read()

    def forward(self, route: str, body: bytes, *,
                timeout: float = 60.0) -> tuple[int, bytes, str]:
        """POST ``body`` to this replica verbatim; returns (status, payload,
        content type). HTTP error statuses are returned, not raised: the
        router decides whether a 5xx means failover. Transport errors raise
        :class:`ReplicaError`."""
        req = urllib.request.Request(self.base_url + route, data=body,
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
                return resp.status, resp.read(), resp.headers.get("Content-Type",
                                                                  "application/json")
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read(), exc.headers.get("Content-Type", "application/json")
        except (urllib.error.URLError, OSError, TimeoutError, http.client.HTTPException) as exc:
            # a replica killed mid-reply ends the read with IncompleteRead,
            # an HTTPException that is not an OSError (JAX's lets it escape
            # into the router's handler)
            raise ReplicaError(f"replica {self.replica_id} unreachable at "
                               f"{self.base_url}{route}: {exc!r}") from exc

    def healthy(self) -> bool:
        """Liveness and readiness: a replica that answers ``/healthz`` but
        not ``/readyz`` (its pipeline still starting) is not routable yet;
        the manager's boot grace keeps it from being drained meanwhile."""
        if self.proc is not None and self.proc.poll() is not None:
            return False
        try:
            live, _ = self._get("/healthz", self.probe_timeout_s)
            ready, _ = self._get("/readyz", self.probe_timeout_s)
        except (urllib.error.URLError, OSError, TimeoutError):
            return False
        return live == 200 and ready == 200

    def scrape(self) -> dict:
        try:
            status, payload = self._get("/v1/statistics", self.probe_timeout_s)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            raise ReplicaError(
                f"replica {self.replica_id} statistics scrape failed: {exc}") from exc
        if status != 200:
            raise ReplicaError(f"replica {self.replica_id} statistics scrape: HTTP {status}")
        try:
            return json.loads(payload.decode("utf-8"))
        except ValueError as exc:
            raise ReplicaError(
                f"replica {self.replica_id} statistics not JSON: {exc}") from exc

    def stop(self, timeout: float = 5.0) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)
