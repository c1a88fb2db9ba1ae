"""LiveTable — a table computed by a BACKGROUND run, with live snapshots.

Parity with reference ``internals/interactive.py:37-160``: the reference
exports the table through an ``ExportDataSink``, runs its subgraph on a
dedicated ``LiveTableThread``, and serves ``snapshot_at(frontier)`` reads
while the stream keeps flowing. Same shape here: a SubscribeNode feeds a
lock-guarded key→row cache, a daemon thread pumps ONLY the tree-shaken
subgraph behind the table (``GraphRunner([node])``), and ``snapshot()``
reads the cache — the graph is NOT re-run per snapshot.

A retraction removes the visible row when its cells equal that row's:
host values by ``==``, array cells (a tensor on the card or the host, an
ndarray) by dtype, shape and bytes, all of an epoch's in one call
(``persistence.snapshot.row_identities``: one device-to-host copy a
device). JAX compares the row tuples with ``==``, which raises on
distinct multi-element tensors or arrays. ``stop()`` keeps JAX's
``_stop.set(); close()`` a source: a close that lands while a reader's
first read is in flight drops that read in both packages.
"""

from __future__ import annotations

import threading


def _retractions_matching(rows: dict, pending: list) -> set[int]:
    """Indices into ``pending`` of the retractions whose row equals the row
    ``rows`` shows for their key, compared by ``row_identities``."""
    from pathway_tpu_torch.persistence.snapshot import row_identities

    pairs = [(i, rows[k], row) for i, (k, row, is_addition) in enumerate(pending)
             if not is_addition and k in rows]
    ids = row_identities([r for _i, cur, row in pairs for r in (cur, row)])
    return {i for n, (i, _c, _r) in enumerate(pairs) if ids[2 * n] == ids[2 * n + 1]}


class LiveTable:
    """Live view of a table: construction starts a background run of the
    table's subgraph; ``snapshot()`` returns the current consistent state
    as a pandas frame without re-running anything; ``stop()`` closes the
    subgraph's connectors and joins the thread.

    Do not separately ``pw.run()`` a pipeline sharing this table's source
    connectors while the live run is active — sources are single-consumer
    (the reference requires an empty graph for interactive mode for the
    same reason).
    """

    def __init__(self, table, *, start_timeout: float | None = 30.0):
        from pathway_tpu_torch.engine.operators.output import SubscribeNode
        from pathway_tpu_torch.internals.parse_graph import G

        self._table = table
        self._columns = list(table.column_names())
        self._lock = threading.Lock()
        self._rows: dict[int, tuple] = {}
        self._frontier: int = -1
        self._first_flush = threading.Event()
        self._finished = threading.Event()
        self.exception: BaseException | None = None
        cols = self._columns
        # per-epoch staging: deltas accumulate here and apply to the
        # visible cache ATOMICALLY at epoch end, retractions first — row
        # callbacks within one consolidated batch are not order-guaranteed
        # for same-key update pairs (engine/state.py:55 applies deletes
        # first for the same reason), and snapshots must never observe a
        # half-applied epoch
        pending: list[tuple[int, tuple, bool]] = []

        def on_change(key, row, time, is_addition):
            pending.append(
                (int(key.value), tuple(row[c] for c in cols), is_addition)
            )

        def on_time_end(time):
            with self._lock:
                # deletions only shrink the map: a retraction meets either
                # the row visible at the epoch's start or none
                match = _retractions_matching(self._rows, pending)
                for i, (k, row, is_addition) in enumerate(pending):
                    if i in match and k in self._rows:
                        del self._rows[k]
                for k, row, is_addition in pending:
                    if is_addition:
                        self._rows[k] = row
                pending.clear()
                self._frontier = time
            self._first_flush.set()

        self._node = SubscribeNode(
            G.engine_graph,
            table._node,
            on_change=on_change,
            on_time_end=on_time_end,
            name="LiveTable",
        )
        # connectors of this tree-shaken subgraph: the background runner
        # starts exactly these, and stop() closes exactly these
        involved = {n.id for n in G.engine_graph.topo_order([self._node])}
        self._connectors = [c for c in G.connectors if c.node.id in involved]
        self._thread = threading.Thread(
            target=self._run_background,
            name=f"pathway:live-{id(self):x}",
            daemon=True,
        )
        self._thread.start()
        if start_timeout is not None:
            self._first_flush.wait(timeout=start_timeout)

    def _run_background(self) -> None:
        from pathway_tpu_torch.internals.monitoring import MonitoringLevel
        from pathway_tpu_torch.internals.run import GraphRunner

        try:
            GraphRunner(
                [self._node], monitoring_level=MonitoringLevel.NONE
            ).run()
        except BaseException as exc:  # noqa: BLE001 - surfaced via failed()
            self.exception = exc
        finally:
            self._first_flush.set()
            self._finished.set()

    # -- state inspection --------------------------------------------------
    @property
    def frontier(self) -> int:
        """Last commit time reflected in the snapshot (-1 = none yet)."""
        with self._lock:
            return self._frontier

    def failed(self) -> bool:
        return self.exception is not None

    def done(self) -> bool:
        """The background run finished (sources closed / static inputs)."""
        return self._finished.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the background run finishes; True if it did."""
        return self._finished.wait(timeout=timeout)

    def snapshot(self):
        """Current consistent state as a pandas frame (id-indexed, like
        ``pw.debug.table_to_pandas``) — a cache read, not a re-run."""
        import pandas as pd

        from pathway_tpu_torch.engine.value import Pointer

        if self.exception is not None:
            raise RuntimeError(
                "LiveTable background run failed"
            ) from self.exception
        with self._lock:
            items = sorted(self._rows.items())
        data: dict[str, list] = {c: [] for c in self._columns}
        keys = []
        for k, row in items:
            keys.append(Pointer(k))
            for c, v in zip(self._columns, row):
                data[c].append(v)
        df = pd.DataFrame(data, columns=self._columns)
        df.index = pd.Index(keys, name="id")
        return df

    def stop(self, timeout: float | None = 10.0) -> None:
        """Close this subgraph's sources and join the background thread."""
        for c in self._connectors:
            c._stop.set()
            c.close()
        self._thread.join(timeout=timeout)

    # -- display -----------------------------------------------------------
    def __str__(self) -> str:
        header = (
            "final snapshot"
            if self.done()
            else f"snapshot at time {self.frontier}"
        )
        return header + "\n" + str(self.snapshot())

    def _repr_html_(self):
        try:
            return self.snapshot()._repr_html_()
        except Exception:  # noqa: BLE001
            return repr(self)


class InteractiveModeController:
    """Tracks LiveTables started while interactive mode is on so one call
    can stop every background run (reference ``interactive.py:203`` returns
    the graph's controller)."""

    def __init__(self):
        self._live: list[LiveTable] = []
        self.enabled = True

    def register(self, live: "LiveTable") -> None:
        self._live.append(live)

    def stop(self) -> None:
        for lt in self._live:
            try:
                lt.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._live.clear()
        self.enabled = False


_controller: InteractiveModeController | None = None


def enable_interactive_mode() -> InteractiveModeController:
    """Switch the process into interactive (notebook) mode: ``Table.live()``
    tables register with the returned controller, and ``controller.stop()``
    tears all of them down (reference ``interactive.py:203-220``)."""
    import warnings

    global _controller
    warnings.warn("interactive mode is experimental", stacklevel=2)
    if _controller is None or not _controller.enabled:
        _controller = InteractiveModeController()
    return _controller


def get_interactive_controller() -> "InteractiveModeController | None":
    return _controller
