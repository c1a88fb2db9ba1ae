"""Multi-process row exchange — the TCP cluster data plane.

The reference scales across processes with timely's zero-copy TCP exchange
channels: rows hop to the worker that owns their shard (low key bits) before
every stateful operator, and progress (frontier) gossip rides the same
sockets (``external/timely-dataflow/communication/``, SURVEY.md §2.5). This
module is the engine's equivalent, for ``EngineConfig(processes=N)``:

* ``PeerMesh`` — a full mesh of length-prefixed pickle sockets between the
  ``processes`` processes on localhost (``first_port + process_id``).
  Message receipt is PULL-based: the thread waiting for a message drains the
  sockets itself (``poll`` + select). The engine is lockstep, so exactly one
  thread waits at a time — no reader threads to starve, crash, or race (an
  earlier reader-thread design hung under load). Every connect, accept and
  wait is bounded.
* ``ExchangeContext`` — epoch-aligned primitives on top of the mesh:
  ``control_allgather`` (lockstep scheduler rounds: agree on the next global
  epoch time and on termination) and ``exchange`` (per-operator data barrier:
  each process contributes its outbound shards for one (exchange, time) and
  collects everyone else's).
* ``ExchangeNode`` — spliced in front of every stateful operator by
  ``splice_exchanges``; routes each row to ``shard_of_key(routing_key) %
  processes``. Groupbys route by the group key, joins by the join key (both
  sides agree), ``ix`` by the row its pointer names, index additions to
  every process, everything else by row key — the reference's ``Shard``
  trait mapping (src/engine/dataflow/shard.rs).

What crosses the wire is host data: keys, diffs and the column arrays,
pickled. A ``torch.Tensor`` cell (a UDF may return one on the card) goes
as a CPU numpy array with its dtype and device, and comes back as a tensor
on the same device of the receiving process: it never pickles as a CUDA
tensor. Each process keeps its own device work (its UDFs, its index).
"""

from __future__ import annotations

import errno
import pickle
import select
import socket
import struct
import sys
import threading
import time as time_mod
from collections import defaultdict
from typing import Any

import numpy as np

from pathway_tpu_torch.engine.batch import Batch, concat_batches
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.value import keys_for_value_columns, shard_of_keys

_LEN = struct.Struct("<Q")

# how long a bind waits out a port that is briefly held (a launcher's
# free-port probe, a socket in TIME_WAIT) before it gives up
BIND_RETRY_S = 5.0


class PeerMesh:
    """Full TCP mesh between localhost processes; one socket per peer pair."""

    def __init__(self, process_id: int, processes: int, first_port: int,
                 host: str = "127.0.0.1", connect_timeout: float = 60.0):
        self.process_id = process_id
        self.processes = processes
        self.peers = [p for p in range(processes) if p != process_id]
        self._socks: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self.lock = threading.Condition()
        # buffers filled by whichever thread polls
        self.data: dict[tuple, list] = defaultdict(list)   # (ex, t) -> payloads
        self.done: dict[tuple, set] = defaultdict(set)     # (ex, t) -> peers
        self.ctl: dict[int, dict[int, Any]] = defaultdict(dict)  # round -> {peer: payload}
        self.closed = False
        self.bytes_sent = 0
        self.bytes_received = 0

        self._srv = _bind(host, first_port + process_id, processes)
        accepted: dict[int, socket.socket] = {}
        n_accept = len([p for p in self.peers if p > process_id])
        deadline = time_mod.monotonic() + connect_timeout

        def acceptor():
            try:
                for _ in range(n_accept):
                    self._srv.settimeout(max(0.01, deadline - time_mod.monotonic()))
                    conn, _ = self._srv.accept()
                    conn.settimeout(max(0.01, deadline - time_mod.monotonic()))
                    hello, _n = _recv_frame(conn)
                    accepted[hello[1]] = conn
            except OSError:
                return  # the missing peers are reported below

        at = threading.Thread(target=acceptor, daemon=True, name="pathway:accept")
        at.start()
        try:
            # deterministic direction: the higher pid dials the lower
            for p in self.peers:
                if p < process_id:
                    while True:
                        try:
                            s = socket.create_connection((host, first_port + p), timeout=2.0)
                            break
                        except OSError:
                            if time_mod.monotonic() > deadline:
                                raise TimeoutError(f"cannot reach peer {p} on port "
                                                   f"{first_port + p}") from None
                            time_mod.sleep(0.05)
                    s.settimeout(max(0.01, deadline - time_mod.monotonic()))
                    s.sendall(_encode(("hello", process_id)))
                    self._socks[p] = s
            at.join(timeout=max(0.0, deadline - time_mod.monotonic()) + 1.0)
            self._socks.update(accepted)
            missing = set(self.peers) - set(self._socks)
            if missing:
                raise TimeoutError(f"peers never connected: {sorted(missing)}")
        except BaseException:
            self.close()
            raise
        self._peer_of_sock: dict[socket.socket, int] = {}
        for p, s in self._socks.items():
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # bound every socket op: a peer that stalls mid-message (without
            # closing) must surface as an error, not an unbounded block
            s.settimeout(600.0)
            self._send_locks[p] = threading.Lock()
            self._peer_of_sock[s] = p
        self._recv_lock = threading.Lock()

    def _store(self, peer: int, msg: tuple) -> None:
        kind = msg[0]
        with self.lock:
            if kind == "data":
                _, ex, t, payload = msg
                self.data[(ex, t)].append(payload)
            elif kind == "done":
                _, ex, t = msg
                self.done[(ex, t)].add(peer)
            elif kind == "ctl":
                _, rnd, payload = msg
                self.ctl[rnd][peer] = payload

    def _drain_ready(self, timeout: float) -> bool:
        ready, _, _ = select.select(list(self._peer_of_sock), [], [], timeout)
        for s in ready:
            msg, n = _recv_frame(s)
            self.bytes_received += n
            self._store(self._peer_of_sock[s], msg)
        return bool(ready)

    def poll(self, timeout: float) -> bool:
        """Drain any ready peer messages into the buffers (pull model: the
        thread WAITING for a message receives it itself). Returns True if
        anything arrived."""
        with self._recv_lock:
            try:
                return self._drain_ready(timeout)
            except (OSError, EOFError):
                with self.lock:
                    self.closed = True
                raise ConnectionError("peer mesh closed") from None

    def _try_drain(self) -> None:
        """Opportunistic non-blocking drain (used mid-send so two peers
        simultaneously sending large payloads cannot deadlock on full
        socket buffers — each keeps consuming while it produces)."""
        if self._recv_lock.acquire(blocking=False):
            try:
                while self._drain_ready(0):
                    pass
            except (OSError, EOFError):
                with self.lock:
                    self.closed = True
            finally:
                self._recv_lock.release()

    def send(self, peer: int, msg: tuple) -> None:
        self.send_blob(peer, _encode(msg))

    def send_blob(self, peer: int, blob: bytes) -> None:
        """Send a pre-encoded frame, draining inbound traffic whenever the
        peer's receive window stalls our send (head-of-line deadlock
        avoidance for mutual large transfers)."""
        sock = self._socks[peer]
        view = memoryview(blob)
        with self._send_locks[peer]:
            sent = 0
            while sent < len(blob):
                _, writable, _ = select.select([], [sock], [], 0.2)
                if writable:
                    sent += sock.send(view[sent:])
                else:
                    self._try_drain()
                    if self.closed:
                        raise ConnectionError("peer mesh closed mid-send")
        with self.lock:  # several exchanges may send at once (threads > 1)
            self.bytes_sent += len(blob)

    def close(self) -> None:
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        try:
            self._srv.close()
        except OSError:
            pass


def _bind(host: str, port: int, backlog: int) -> socket.socket:
    """A listening socket on ``port``; a port in use is retried for
    ``BIND_RETRY_S`` before the error is raised."""
    deadline = time_mod.monotonic() + BIND_RETRY_S
    while True:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host, port))
            srv.listen(backlog)
            return srv
        except OSError as exc:
            srv.close()
            if exc.errno != errno.EADDRINUSE or time_mod.monotonic() > deadline:
                raise
            time_mod.sleep(0.1)


def _encode(msg: tuple) -> bytes:
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(blob)) + blob


def _recv_frame(sock: socket.socket) -> tuple[Any, int]:
    """One message and its size on the wire."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n)), _LEN.size + n


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise EOFError("peer closed")
        got += k
    return bytes(buf)


class ExchangeContext:
    """Epoch-aligned collectives over a PeerMesh."""

    def __init__(self, mesh: PeerMesh, timeout: float = 300.0):
        self.mesh = mesh
        self.process_id = mesh.process_id
        self.processes = mesh.processes
        self.timeout = timeout
        self.control_rounds = 0
        self._n_exchanges = 0
        self._n_iterate_bases = 0

    def next_exchange_id(self) -> int:
        ex = self._n_exchanges
        self._n_exchanges += 1
        return ex

    def next_iterate_ctl_base(self) -> int:
        """A private control-tag namespace for one IterateNode. Disjoint
        from scheduler rounds (small ints) and the flush rounds (1<<40);
        tags are drawn one at a time from the 1<<34-wide range (~17e9 —
        unreachable in any real run), and distinct iterate nodes can never
        collide. Allocation order is deterministic (same splice walk on
        every process), so bases line up across the mesh."""
        base = (1 << 50) + self._n_iterate_bases * (1 << 34)
        self._n_iterate_bases += 1
        return base

    def counters(self) -> dict[str, int]:
        return {"bytes_sent": self.mesh.bytes_sent,
                "bytes_received": self.mesh.bytes_received,
                "control_rounds": self.control_rounds}

    # ---------------------------------------------------------------- control
    def control_allgather(self, rnd: int, payload) -> dict[int, Any]:
        """Send payload for lockstep round ``rnd``; return {pid: payload}
        for ALL processes (self included)."""
        with self.mesh.lock:
            self.control_rounds += 1
        for p in self.mesh.peers:
            self.mesh.send(p, ("ctl", rnd, payload))
        deadline = time_mod.monotonic() + self.timeout
        while True:
            with self.mesh.lock:
                got = self.mesh.ctl.get(rnd, {})
                if len(got) == len(self.mesh.peers):
                    out = dict(got)
                    del self.mesh.ctl[rnd]
                    out[self.process_id] = payload
                    return out
                if self.mesh.closed:
                    raise ConnectionError("peer mesh closed mid-round")
            self.mesh.poll(0.25)
            if time_mod.monotonic() > deadline:
                raise TimeoutError(f"control round {rnd} timed out")

    # ------------------------------------------------------------------- data
    def exchange(self, ex: int, t: int, outbound: dict[int, Batch],
                 broadcast: Batch | None = None) -> list[Batch]:
        """Contribute per-peer batches for (exchange ex, time t); block until
        every peer's DONE marker for the same (ex, t) arrives; return the
        batches peers sent here. ``broadcast`` sends ONE batch to every peer
        (encoded once, not per peer)."""
        done_blob = _encode(("done", ex, t))
        if broadcast is not None and len(broadcast):
            data_blob = _encode(("data", ex, t, _pack_batch(broadcast)))
            for p in self.mesh.peers:
                self.mesh.send_blob(p, data_blob)
                self.mesh.send_blob(p, done_blob)
        else:
            for p in self.mesh.peers:
                b = outbound.get(p)
                if b is not None and len(b):
                    self.mesh.send(p, ("data", ex, t, _pack_batch(b)))
                self.mesh.send_blob(p, done_blob)
        deadline = time_mod.monotonic() + self.timeout
        while True:
            with self.mesh.lock:
                if self.mesh.done.get((ex, t), set()) >= set(self.mesh.peers):
                    payloads = self.mesh.data.pop((ex, t), [])
                    del self.mesh.done[(ex, t)]
                    return [_unpack_batch(p) for p in payloads]
                if self.mesh.closed:
                    raise ConnectionError("peer mesh closed mid-exchange")
            self.mesh.poll(0.25)
            if time_mod.monotonic() > deadline:
                raise TimeoutError(f"exchange {ex}@{t} timed out")

    def close(self) -> None:
        self.mesh.close()


class _WireTensor:
    """A tensor cell on the wire: its values as a CPU numpy array (bf16 as
    its int16 bits, numpy having no bf16), its dtype and its device."""

    __slots__ = ("array", "dtype", "device")

    def __init__(self, tensor):
        import torch

        t = tensor.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        self.array = t.numpy()
        self.dtype = str(tensor.dtype).removeprefix("torch.")
        self.device = str(tensor.device)

    def __getstate__(self):
        return (self.array, self.dtype, self.device)

    def __setstate__(self, state):
        self.array, self.dtype, self.device = state

    def revive(self):
        import torch

        t = torch.from_numpy(self.array)
        dtype = getattr(torch, self.dtype)
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(self.device)


def _wire_column(col: np.ndarray, out_of: type, into) -> np.ndarray:
    """``col`` with every cell of type ``out_of`` replaced by ``into(cell)``
    (a copy; the column itself is left as it is)."""
    if col.dtype != object:
        return col
    hits = [i for i, v in enumerate(col) if isinstance(v, out_of)]
    if not hits:
        return col
    col = col.copy()
    for i in hits:
        col[i] = into(col[i])
    return col


def _pack_batch(b: Batch):
    torch = sys.modules.get("torch")
    cols = b.cols
    if torch is not None:
        cols = {n: _wire_column(c, torch.Tensor, _WireTensor) for n, c in cols.items()}
    return (b.keys, cols, b.diffs)


def _unpack_batch(p) -> Batch:
    keys, cols, diffs = p
    cols = {n: _wire_column(c, _WireTensor, _WireTensor.revive) for n, c in cols.items()}
    return Batch(keys, cols, diffs)


# --------------------------------------------------------------------------- #
# exchange operator + splice pass


class ExchangeNode(Node):
    """Route rows to their owner process before a stateful operator.

    ``routing`` is None (route by row key), a list of column names whose
    values hash to the routing key (group/join keys), a tuple
    ``("ptr", col)`` — route to the shard OWNING the row the pointer
    column references (ix gathers co-locate with their targets) — or the
    string ``"broadcast"`` — every process receives every row (the
    reference's per-worker external-index instances see the full
    add-stream)."""

    # must step EVERY epoch even with no local deltas: the exchange is a
    # collective — peers with data block until this side joins (so the
    # scheduler's sparse-stepping skip does not apply)
    always_step = True

    def __init__(self, graph, input_node, ctx: ExchangeContext,
                 routing, name="Exchange"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.ctx = ctx
        self.ex_id = ctx.next_exchange_id()
        self.routing = routing

    def _routing_keys(self, batch: Batch) -> np.ndarray:
        if self.routing is None:
            return batch.keys
        if isinstance(self.routing, tuple) and self.routing[0] == "ptr":
            from pathway_tpu_torch.engine.value import Pointer

            col = batch.cols[self.routing[1]]
            out = np.empty(len(batch), dtype=np.uint64)
            for i, p in enumerate(col):
                # None/ERROR pointers route to shard 0 (the target is
                # missing everywhere; one shard must own the miss)
                out[i] = p.value if isinstance(p, Pointer) else 0
            return out
        return keys_for_value_columns(
            [batch.cols[c] for c in self.routing], len(batch)
        )

    def step(self, time, ins):
        (batch,) = ins
        n = self.ctx.processes
        me = self.ctx.process_id
        local = None
        outbound: dict[int, Batch] = {}
        if self.routing == "broadcast":
            if batch is not None and len(batch):
                local = batch
            received = self.ctx.exchange(self.ex_id, time, {}, broadcast=local)
            self._record_rows(
                broadcast=(len(local) * len(self.ctx.mesh.peers)
                           if local is not None else 0),
                received=sum(len(b) for b in received),
            )
            parts = [b for b in [local, *received] if b is not None and len(b)]
            return concat_batches(parts) if parts else None
        if batch is not None and len(batch):
            shards = shard_of_keys(self._routing_keys(batch), n)
            local_mask = shards == me
            if local_mask.all():
                local = batch
            else:
                local = batch.take(local_mask)
                for p in range(n):
                    if p == me:
                        continue
                    m = shards == p
                    if m.any():
                        outbound[p] = batch.take(m)
        received = self.ctx.exchange(self.ex_id, time, outbound)
        self._record_rows(
            local=len(local) if local is not None else 0,
            sent=sum(len(b) for b in outbound.values()),
            received=sum(len(b) for b in received),
        )
        parts = [b for b in [local, *received] if b is not None and len(b)]
        if not parts:
            return None
        return concat_batches(parts)

    def _record_rows(self, **rows: int) -> None:
        """Exchange row counters: the run's ``SchedulerStats`` always, the
        registry when the owning scheduler's operator telemetry is on."""
        sched = getattr(self, "scheduler", None)
        if sched is None:
            return
        sched.stats.record_exchange(**rows)
        if getattr(sched, "op_metrics", False):
            from pathway_tpu_torch.engine import probes

            probes.record_exchange(**rows)


def splice_exchanges(graph, order: list[Node],
                     ctx: ExchangeContext) -> list[tuple[Node, int, Node]]:
    """Insert ExchangeNodes in front of every stateful operator's inputs.

    Must be deterministic across processes: the graph build is identical on
    every process (same program), and this pass walks the same topo order,
    so exchange ids line up. Returns the list of (node, input_index,
    original_input) rewirings so the caller can undo them on teardown — the
    graph is the user's global object and must not keep exchanges bound to
    a dead mesh across runs."""
    from pathway_tpu_torch.engine.operators.core import IxNode
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexNode
    from pathway_tpu_torch.engine.operators.join import JoinNode
    from pathway_tpu_torch.engine.operators.reduce import GroupbyNode
    from pathway_tpu_torch.internals.iterate import IterateNode, IterateSiblingNode

    spliced: list[tuple[Node, int, Node]] = []
    for node in list(order):
        if isinstance(node, ExchangeNode):
            continue
        if isinstance(node, IterateSiblingNode):
            # reads the primary's LOCAL fixpoint results directly; its
            # input edge exists only for topo ordering — never exchange it
            continue
        if isinstance(node, IterateNode):
            # splice the FIXPOINT SUBGRAPH too (reference iterate subscopes
            # run across workers — dataflow.rs:3737): every process runs
            # each round over its shard with rows exchanged in front of the
            # subgraph's stateful operators, and the node coordinates
            # per-round lockstep + global convergence through its private
            # control namespace. Idempotent: a sub-scheduler re-walking an
            # already-spliced subgraph must not re-wire it.
            if node.exchange_ctx is not ctx:
                node.exchange_ctx = ctx
                node.ctl_base = ctx.next_iterate_ctl_base()
                caps = node.ensure_captures()
                sub_order = node.subgraph.topo_order(caps)
                spliced.extend(splice_exchanges(node.subgraph, sub_order, ctx))
                spliced.append((node, -1, None))  # teardown: clear ctx
            routings: list = [None] * len(node.inputs)  # route by row key
        elif isinstance(node, ExternalIndexNode):
            # index additions broadcast so every process's index instance
            # holds the full corpus (reference: one instance per worker fed
            # the whole add-stream); queries stay sharded by row key and
            # are each answered exactly once, against the complete index
            routings = ["broadcast", None]
        elif isinstance(node, GroupbyNode):
            routings = [[node.instance_col] if node.instance_col else node.group_cols]
        elif isinstance(node, JoinNode):
            routings = [node.left_on, node.right_on]
        elif isinstance(node, IxNode):
            # pointer gathers co-locate with their TARGET row's shard;
            # the source side keeps row-key routing, so lookup and
            # target always land on the same process
            routings = [("ptr", node.ptr_column), None]
        elif node.is_stateful():
            routings = [None] * len(node.inputs)
        else:
            continue
        for i, inp in enumerate(node.inputs):
            if isinstance(inp, ExchangeNode):
                continue
            routing = routings[i] if i < len(routings) else None
            ex = ExchangeNode(graph, inp, ctx, routing, name=f"Exchange->{node.name}")
            node.inputs[i] = ex
            spliced.append((node, i, inp))
    return spliced


def unsplice_exchanges(spliced: list[tuple[Node, int, Node]]) -> None:
    """Undo a splice pass: restore original inputs (teardown of one run).
    ``input_index == -1`` entries clear an IterateNode's exchange binding —
    the graph is the user's global object and must not keep a dead mesh.
    The spliced ExchangeNodes leave their graphs too."""
    for node, i, orig in spliced:
        if i == -1:
            node.exchange_ctx = None
            continue
        ex = node.inputs[i]
        node.inputs[i] = orig
        if isinstance(ex, ExchangeNode) and ex in ex.graph.nodes:
            ex.graph.nodes.remove(ex)
