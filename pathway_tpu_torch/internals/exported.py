"""Export/import between graphs — frontier-tracked table handoff.

Reference: ``api.ExportedTable`` (``src/engine/graph.rs`` ExportedTable with
``frontier()`` / ``snapshot_at()``; consumed by
``internals/interactive.py:35-77`` and the export/import datasink/source
pair). Redesign for this engine:

* ``export_table(table)`` (graph A, at build time) attaches a capture sink;
  while graph A runs, the handle tracks the table's consolidated state, a
  compacted update history, and the commit-time frontier.
* ``import_table(exported)`` (graph B) creates an input connector that
  emits a CONSISTENT snapshot as of the exported frontier, then streams
  subsequent updates live — graph B can run while graph A is still running
  (each exported update is queued per importer), and quiesces when graph A
  finishes.

Cells are compared by value: a tensor (on the card or the host) or a numpy
array by its dtype, shape and bytes, as the snapshot log does
(``persistence/snapshot.py`` ``row_identities``). Two tensor objects holding
one vector are one row, so an update's retraction cancels its insertion
even when the engine handed over a copy; JAX hashes the row tuple, which
keys a tensor by its identity and refuses an ndarray. The CUDA cells a
consolidation compares go to the host in one transfer a device, not one a
row.
"""

from __future__ import annotations

import queue
import threading

import torch

from pathway_tpu_torch.engine.operators.core import InputNode
from pathway_tpu_torch.engine.operators.output import SinkNode
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io._streams import BaseConnector
from pathway_tpu_torch.persistence.snapshot import row_identities

_FINISHED = object()  # queue sentinel: the exporting run ended

# history entries before in-place consolidation; past a compaction that
# left L rows, the next waits for 2 * L entries, so each entry is hashed a
# bounded number of times however large the live set (JAX compacts at every
# batch once its live set passes the threshold)
_COMPACT_THRESHOLD = 10_000


def _consolidate(
    hist: list[tuple[int, int, tuple, int]],
    frontier: int,
    on_later=None,
) -> list[tuple[int, tuple]]:
    """Net state from every update with ``time <= frontier``; entries past
    the cut go to ``on_later`` (ordered) when given. Rows are told apart by
    ``row_identities``; a surviving row is the first object seen for it."""
    cut = []
    for entry in hist:
        if entry[0] > frontier:
            if on_later is not None:
                on_later(entry)
            continue
        cut.append(entry)
    ids = row_identities([row for _t, _k, row, _d in cut])
    net: dict[tuple, int] = {}
    first: dict[tuple, tuple[int, tuple]] = {}
    for (_time, key, row, diff), rid in zip(cut, ids):
        ck = (key, rid)
        if ck not in net:
            net[ck] = 0
            first[ck] = (key, row)
        net[ck] += diff
    out: list[tuple[int, tuple]] = []
    for ck, n in net.items():
        for _ in range(max(0, n)):
            out.append(first[ck])
    return out


def _cuda_devices(batch) -> set:
    """The CUDA devices of a batch's tensor cells (a column holds one type
    of cell, so its first cell stands for it)."""
    devs = set()
    for col in batch.cols.values():
        if len(col) and isinstance(col[0], torch.Tensor) and col[0].is_cuda:
            devs.add(col[0].device)
    return devs


class ExportedTable:
    """Frontier-tracked handle to a table's live state."""

    def __init__(self, table: Table):
        self.column_names = list(table.column_names())
        self.schema = table.schema
        self._lock = threading.Lock()
        self._history: list[tuple[int, int, tuple, int]] = []
        self._frontier: int = 0
        self._queues: list[queue.Queue] = []
        self._finished = False
        self.compactions = 0
        self._compacted_rows = 0  # rows the last compaction left
        # device -> the event recorded after the newest batch with cells on
        # it (see _order_after)
        self._ready: dict[torch.device, torch.cuda.Event] = {}

        def on_batch(time: int, batch) -> None:
            # Rows with CUDA cells: an event is recorded on this (the
            # engine's) thread's current stream once the batch reached the
            # sink. The engine's producers hand over tensors ready on that
            # stream (the deferred UDF waits each batch's done event before
            # it injects), so the event completes after every cell of the
            # batch, and of every earlier batch, is written. A reader on
            # another thread makes its own stream wait on the newest event
            # (a stream wait, not a device sync) before it touches a cell.
            events = {}
            for dev in _cuda_devices(batch):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events[dev] = ev
            with self._lock:
                self._ready.update(events)
                for key, row, diff in batch.rows():
                    self._history.append((time, key, row, diff))
                    for q in self._queues:
                        q.put((time, key, row, diff))
                self._frontier = max(self._frontier, time)
                if len(self._history) > max(_COMPACT_THRESHOLD, 2 * self._compacted_rows):
                    self._compact_locked()

        def on_finish() -> None:
            with self._lock:
                self._finished = True
                for q in self._queues:
                    q.put(_FINISHED)

        on_batch.finish = on_finish  # SinkNode end-of-run hook
        node = SinkNode(
            G.engine_graph, table._node, on_batch,
            name=f"export({','.join(self.column_names)})",
        )
        G.register_sink(node)

    def _order_after(self) -> None:
        """Make the calling thread's current stream wait for every cell
        exported so far (one event a device; nothing without CUDA cells)."""
        with self._lock:
            events = list(self._ready.items())
        for dev, ev in events:
            torch.cuda.current_stream(dev).wait_event(ev)

    def _compact_locked(self) -> None:
        """Collapse history up to the frontier into its net state (bounds
        memory on streaming sources; snapshots at frontiers earlier than a
        compaction point are no longer distinguishable, matching the
        reference's as-of-now export semantics). Runs on the engine's
        thread, on whose stream every event was recorded: no wait needed."""
        later: list = []
        rows = _consolidate(self._history, self._frontier, later.append)
        self._history = [
            (self._frontier, key, row, 1) for key, row in rows
        ] + later
        self._compacted_rows = len(rows)
        self.compactions += 1

    # -- reference ExportedTable surface ----------------------------------
    def frontier(self) -> int:
        with self._lock:
            return self._frontier

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finished

    def snapshot_at(self, frontier: int) -> list[tuple[int, tuple]]:
        """Consolidated (key, row) state after every update with
        ``time <= frontier``."""
        with self._lock:
            hist = list(self._history)
        self._order_after()
        return _consolidate(hist, frontier)

    def consistent_handoff(self) -> tuple[int, list, "queue.Queue"]:
        """(frontier, snapshot rows, queue of later updates) atomically; the
        queue ends with a sentinel once the exporting run finishes."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            frontier = self._frontier
            hist = list(self._history)
            finished = self._finished
            if not finished:
                self._queues.append(q)
        self._order_after()
        rows = _consolidate(hist, frontier, q.put)
        if finished:
            q.put(_FINISHED)
        return frontier, rows, q

    def _drop_queue(self, q: queue.Queue) -> None:
        with self._lock:
            try:
                self._queues.remove(q)
            except ValueError:
                pass


class _ImportConnector(BaseConnector):
    """Emits the exported snapshot, then streams later updates until the
    exporting run finishes (or this run stops)."""

    heartbeat_ms = 500

    def __init__(self, node, exported: ExportedTable, follow: bool = True):
        super().__init__(node)
        self.exported = exported
        self.follow = follow

    def _commit(self, rows) -> None:
        self.exported._order_after()
        self.commit_rows(rows)

    def run(self) -> None:
        frontier, rows, updates = self.exported.consistent_handoff()
        try:
            self.commit_rows([(key, row, 1) for key, row in rows])
            if not self.follow:
                return
            while not self.should_stop():
                try:
                    item = updates.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _FINISHED:
                    return
                batch = [(item[1], item[2], item[3])]
                # drain whatever else is queued into one commit
                while True:
                    try:
                        nxt = updates.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _FINISHED:
                        self._commit(batch)
                        return
                    batch.append((nxt[1], nxt[2], nxt[3]))
                self._commit(batch)
        finally:
            self.exported._drop_queue(updates)


def export_table(table: Table) -> ExportedTable:
    """Attach an export capture to ``table`` (reference ``Scope.export_table``)."""
    return ExportedTable(table)


def import_table(exported: ExportedTable, *, follow: bool = True) -> Table:
    """Materialize an :class:`ExportedTable` in the CURRENT graph: snapshot
    at the exported frontier, then (``follow=True``) live updates until the
    exporting run finishes."""
    cols = list(exported.column_names)
    node = InputNode(G.engine_graph, cols, name=f"import({','.join(cols)})")
    conn = _ImportConnector(node, exported, follow=follow)
    G.register_connector(conn)
    return Table(node, exported.schema, Universe())
