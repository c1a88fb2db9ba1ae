"""Prefix-affinity fleet router (counterpart of
``pathway_tpu/serving/router.py``).

:class:`FleetRouter` owns the membership map and the consistent-hash
ring. For each request it derives the prompt-head key
(:func:`~pathway_tpu_torch.serving.hashring.head_block_key`, blocks of the
replicas' prefix-cache block) and orders the candidates: the ring owner
first, then the other members as failover targets. ``affinity_blocks=0``
drops the key and round-robins.

A submission that raises (a dead serving loop, an injected
``router.forward`` fault) moves to the next candidate at once. A request
whose replica dies in flight (it resolves with ``text is None`` and no
shed reason) is re-queued on the next untried candidate inside
:meth:`FleetCompletion.wait`; each replica is tried at most once per
request. A shed (``error_reason`` ``"shed:*"``) is the replica's answer
and is returned, not retried.

:class:`RouterServer` is the HTTP front end (``http.server``): it
forwards POST bodies to members that have a ``forward`` method with the
same candidate order, and serves ``/healthz``, ``/readyz``, ``/metrics``
(the port's ``openmetrics_text``) and ``/v1/fleet``.
"""

from __future__ import annotations

import json
import threading
import time

from pathway_tpu_torch.analysis.annotations import guarded_by
from pathway_tpu_torch.analysis.runtime import make_lock
from pathway_tpu_torch.engine import chaos, probes
from pathway_tpu_torch.serving.hashring import HashRing, affinity_block_tokens, head_block_key
from pathway_tpu_torch.serving.replica import ReplicaError


def _char_tokenize(text: str) -> list:
    """The router's fallback tokenizer: one stable id per character.
    Affinity needs only a stable prompt -> tokens map; pass the replicas'
    tokenizer (``FleetRouter(tokenize=...)``) for block boundaries that
    agree with their caches."""
    return [(ord(c) % 96) + 1 for c in str(text)]


class FleetCompletion:
    """One request at fleet level: the replica's pending completion, and
    its re-dispatch when that replica dies. :meth:`wait` runs the failover
    on the caller's thread. Terminal states: an answer, a shed reason, or
    ``error_reason == "fleet:no_replica"`` when no candidate is left."""

    def __init__(self, prompt, max_new: int | None, priority: int) -> None:
        self.prompt = prompt
        self.max_new = max_new
        self.priority = priority
        self.attempts: list[str] = []  # replica ids tried, in order
        self.replica_id: str | None = None  # the current binding
        self.done = threading.Event()
        self.text: str | None = None
        self.tokens: list = []
        self.error_reason: str | None = None
        self._req = None  # the replica's live completion
        self._router = None  # set by FleetRouter.submit

    def _finish_from(self, req) -> None:
        self.text = req.text
        self.tokens = list(getattr(req, "tokens", ()) or ())
        self.error_reason = getattr(req, "error_reason", None)
        self.done.set()

    def _fail(self, reason: str) -> None:
        self.text = None
        self.error_reason = reason
        self.done.set()

    def wait(self, timeout: float | None = None, *, router=None) -> bool:
        """Block until terminal (True) or until ``timeout`` seconds pass
        (False)."""
        end = None if timeout is None else time.monotonic() + timeout
        rt = router if router is not None else self._router
        while not self.done.is_set():
            req = self._req
            if req is None or rt is None:  # the dispatch already failed
                self._fail("fleet:no_replica")
                break
            remaining = None
            if end is not None:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
            if not req.done.wait(timeout=remaining):
                return False
            if req.text is not None or getattr(req, "error_reason", None):
                self._finish_from(req)  # answered, or shed on purpose
                break
            # the replica died with the request in flight: next candidate
            probes.REGISTRY.counter_add("requests_requeued")
            if not rt._redispatch(self):
                self._fail("fleet:no_replica")
                break
        return True


@guarded_by(_replicas="_lock", _rr_next="_lock")
class FleetRouter:
    """Membership, the ring, candidate order and dispatch. ``_replicas``
    and ``_rr_next`` are guarded by ``_lock``. Defaults are the JAX flag
    defaults: affinity over 4 head blocks of the prefix-cache block."""

    def __init__(self, *, affinity_blocks: int = 4, block: int | None = None,
                 tokenize=None, vnodes: int = 64) -> None:
        self.affinity_blocks = int(affinity_blocks)
        self.block = affinity_block_tokens() if block is None else int(block)
        self.tokenize = tokenize or _char_tokenize
        self.ring = HashRing(vnodes=vnodes)
        self._lock = make_lock("serving.router")
        self._replicas: dict = {}
        self._rr_next = 0
        self._chaos_forward = chaos.site("router.forward")

    # -- membership ------------------------------------------------------

    def add_replica(self, replica) -> None:
        with self._lock:
            self._replicas[replica.replica_id] = replica
        moved = self.ring.add(replica.replica_id)
        if moved:
            probes.REGISTRY.counter_add("ring_moves", value=float(moved))
        probes.REGISTRY.gauge_set("replica_up", 1.0, replica=replica.replica_id)

    def remove_replica(self, replica_id: str):
        """Take a replica off the ring and the membership; returns its
        handle (or None) for the caller to stop or respawn."""
        with self._lock:
            replica = self._replicas.pop(replica_id, None)
        moved = self.ring.remove(replica_id)
        if moved:
            probes.REGISTRY.counter_add("ring_moves", value=float(moved))
        probes.REGISTRY.gauge_set("replica_up", 0.0, replica=replica_id)
        return replica

    def replicas(self) -> dict:
        with self._lock:
            return dict(self._replicas)

    def get(self, replica_id: str):
        with self._lock:
            return self._replicas.get(replica_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- candidate order ---------------------------------------------------

    def route_key(self, prompt) -> bytes | None:
        if self.affinity_blocks <= 0:
            return None
        return head_block_key(self.tokenize(prompt), block=self.block,
                              blocks=self.affinity_blocks)

    def candidates(self, prompt, exclude=()) -> list:
        """Replica ids for ``prompt`` in order: the ring owner of its head,
        then the rest (sorted) as failover; round-robin without affinity."""
        members = self.ring.members()
        skip = set(exclude)
        order: list = []
        key = self.route_key(prompt)
        if key is not None:
            owner = self.ring.lookup(key)
            if owner is not None:
                order.append(owner)
        else:
            with self._lock:
                self._rr_next += 1
                start = self._rr_next
            if members:
                k = start % len(members)
                members = members[k:] + members[:k]
        for rid in members:
            if rid not in order:
                order.append(rid)
        return [rid for rid in order if rid not in skip]

    # -- dispatch to in-process replicas -------------------------------------

    def submit(self, prompt, max_new: int | None = None, *,
               priority: int = 1) -> FleetCompletion:
        """Route one prompt to its affinity replica, failing over on a
        submission error."""
        fc = FleetCompletion(prompt, max_new, priority)
        fc._router = self
        if not self._redispatch(fc):
            fc._fail("fleet:no_replica")
        return fc

    def _redispatch(self, fc: FleetCompletion) -> bool:
        """Bind ``fc`` to its next untried candidate; False when none is
        left."""
        for rid in self.candidates(fc.prompt, exclude=fc.attempts):
            replica = self.get(rid)
            if replica is None:  # drained meanwhile
                continue
            fc.attempts.append(rid)
            try:
                if self._chaos_forward is not None:
                    self._chaos_forward.maybe_fail()
                req = replica.submit(fc.prompt, fc.max_new, priority=fc.priority)
            except (chaos.InjectedFault, ReplicaError, RuntimeError):
                continue  # the health pass handles the replica
            fc.replica_id = rid
            fc._req = req
            probes.REGISTRY.counter_add("requests_routed", replica=rid)
            return True
        return False


class RouterServer:
    """HTTP front end over a :class:`FleetRouter` whose members forward
    request bodies (a ``forward(path, body) -> (status, body, ctype)``
    method): POSTs to :attr:`ROUTED` go to the candidates in order, a 5xx
    or a transport error moving to the next one."""

    ROUTED = ("/v1/pw_ai_answer", "/v2/answer", "/v1/retrieve", "/v2/retrieve")

    def __init__(self, router: FleetRouter, *, manager=None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.router = router
        self.manager = manager
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def _route_body(self, path: str, body: bytes) -> tuple[int, bytes, str]:
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
        except ValueError:
            payload = {}
        prompt = payload.get("prompt") or payload.get("query") or ""
        for rid in self.router.candidates(prompt):
            replica = self.router.get(rid)
            if replica is None or not hasattr(replica, "forward"):
                continue
            try:
                if self.router._chaos_forward is not None:
                    self.router._chaos_forward.maybe_fail()
                status, out, ctype = replica.forward(path, body)
            except (chaos.InjectedFault, ReplicaError):
                continue
            if status >= 500:
                continue  # the replica failed: next candidate
            probes.REGISTRY.counter_add("requests_routed", replica=rid)
            return status, out, ctype
        return (502, json.dumps({"error": "no replica available"}).encode("utf-8"),
                "application/json")

    def _fleet_state(self) -> dict:
        if self.manager is not None:
            return self.manager.state()
        return {"replicas": {rid: {"kind": getattr(r, "kind", "?")}
                             for rid, r in self.router.replicas().items()},
                "size": len(self.router)}

    def start(self) -> "RouterServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from pathway_tpu_torch.internals.http_server import openmetrics_text

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                text = "text/plain; charset=utf-8"
                if self.path == "/healthz":
                    self._send(200, b"ok\n", text)
                elif self.path == "/readyz":
                    up = len(outer.router) > 0
                    self._send(200 if up else 503,
                               b"ready\n" if up else b"no replicas\n", text)
                elif self.path == "/metrics":
                    self._send(200, openmetrics_text().encode("utf-8"),
                               "application/openmetrics-text; version=1.0.0; charset=utf-8")
                elif self.path in ("/v1/fleet", "/v1/statistics"):
                    self._send(200, json.dumps(outer._fleet_state()).encode("utf-8"),
                               "application/json")
                else:
                    self._send(404, b"not found\n", text)

            def do_POST(self):
                if self.path not in RouterServer.ROUTED:
                    self._send(404, b"not found\n", "text/plain; charset=utf-8")
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                self._send(*outer._route_body(self.path, body))

        class Server(ThreadingHTTPServer):
            # a burst of clients connecting at once must not overflow the
            # listen backlog (the standard library's default is 5; the
            # port's web server and aiohttp use 128)
            request_queue_size = 128
            daemon_threads = True

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-router-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
