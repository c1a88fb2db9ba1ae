"""The connector runtime.

The analog of the reference connector thread loop (``src/connectors/mod.rs``:
``Connector::run`` pumping entries into input sessions with commit times).
A connector owns an engine InputNode; on ``start`` it spawns a thread that
injects batches at increasing even commit times and advances its source
frontier; ``stop`` requests shutdown.

Persistence (as JAX's): a connector with a ``persistent_id`` in a run given
a persistence config appends each commit's rows to its snapshot log, with
``current_offset()`` (the reader's position) in the same chunk. On start it
is rewound: the consolidated log is replayed at one commit time (unless
operator state was restored instead), the reader is sought past the stored
offset, and ``on_replay`` rebuilds the connector's own state from the
replayed rows. The port seeks before ``on_replay`` (JAX after it): the file
reader rebuilds its per-file row map from the rows and the sought file list.
An injected ``persist.put`` fault leaves the rows buffered for the next
commit's chunk and the reader goes on; any other failed store write ends
the connector and fails the run.
"""

from __future__ import annotations

import threading
import time as time_mod
from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node


class BaseConnector:
    """Owns one InputNode; subclasses implement ``run(ctx)``.

    Live (wall-clock-timed) connectors set ``heartbeat_ms``: while the source
    is idle a heartbeat thread keeps advancing its frontier so OTHER sources'
    later events can be processed — the analog of the reference's autocommit
    timer advancing time without data (``src/connectors/mod.rs:207``,
    ``advance_time``). ``commit_rows``/``heartbeat`` share a mutex so a
    commit's time can never fall behind an interleaved heartbeat advance.
    """

    heartbeat_ms: int | None = None
    # several processes: shardable connectors partition their input
    # themselves (e.g. fs by file hash); the others run on process 0 only
    # and rely on ExchangeNodes to route rows to their owners
    shardable: bool = False

    def __init__(self, node: Node):
        from pathway_tpu_torch.engine import chaos

        self.node = node
        self._thread: threading.Thread | None = None
        self._hb_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._sched = None
        self._time_mutex = threading.Lock()
        self._closed = False
        self._sched_closed = False
        self.persistent_id: str | None = None
        self._persistence = None  # PersistenceManager when persistence is on
        self._snapshot_writer = None
        self._persist_error: BaseException | None = None
        self._chaos_read = chaos.site("connector.read")

    # -- persistence hooks (reference: Reader::seek + SnapshotEvent log) ----
    def setup_persistence(self, manager) -> None:
        self._persistence = manager
        if self.persistent_id is not None and manager.do_record:
            self._snapshot_writer = manager.writer_for(self.persistent_id)

    def current_offset(self):
        """Reader position to store with each snapshot chunk; None = source
        is not seekable (replay alone restores it)."""
        return None

    def seek_offset(self, offset) -> None:
        """Fast-forward the reader past data already in the snapshot."""

    def on_replay(self, rows) -> None:
        """Rebuild connector-side state (e.g. upsert maps) from the
        consolidated snapshot rows about to be re-emitted."""

    def _log_commit(self, rows, t: int) -> None:
        from pathway_tpu_torch.engine.chaos import InjectedFault

        w = self._snapshot_writer
        w.write_rows(list(rows.rows()) if isinstance(rows, Batch) else list(rows))
        try:
            w.advance(t, offset=self.current_offset())
        except InjectedFault:
            pass  # raised before the put: the rows go with the next chunk
        except BaseException as exc:
            self._persist_error = exc
            raise

    # -- session API used by run() implementations -------------------------
    def emit(
        self, time: int, rows: "list[tuple[int, tuple, int]] | Batch"
    ) -> None:
        """Inject rows at ``time``. Accepts either per-row triples or an
        already-columnar ``Batch`` (bulk readers build batches directly so
        400k-row commits skip the row-tuple round trip)."""
        if isinstance(rows, Batch):
            if len(rows):
                self._sched.inject(self.node, time, rows)
        elif rows:
            self._sched.inject(
                self.node, time, Batch.from_rows(self.node.column_names, rows)
            )

    def advance(self, new_time: int) -> None:
        if self._closed:
            return
        self._sched.advance_source(self.node, new_time)

    def commit_rows(
        self, rows: "list[tuple[int, tuple, int]] | Batch"
    ) -> int:
        """Atomically emit ``rows`` at a fresh commit time and advance the
        frontier past it (safe against the heartbeat)."""
        if self._chaos_read is not None:
            # raise BEFORE the commit: the batch is either fully injected
            # or not at all, like a real source read failure
            self._chaos_read.maybe_fail()
        with self._time_mutex:
            t = next_commit_time()
            self.emit(t, rows)
            if self._snapshot_writer is not None:
                self._log_commit(rows, t)
            self.advance(t + 1)
            if self._sched is not None:
                self._sched.stats.record_connector_commit(
                    self.node.id, self._stat_name(), len(rows)
                )
            return t

    def _stat_name(self) -> str:
        return f"{type(self).__name__}[{self.node.name}]"

    def close(self) -> None:
        with self._time_mutex:
            self._closed = True
            if self._sched is not None and not self._sched_closed:
                self._sched_closed = True
                self._sched.close_source(self.node)
                self._sched.stats.connector_finished(
                    self.node.id, self._stat_name()
                )

    def should_stop(self) -> bool:
        return self._stop.is_set()

    # -- lifecycle ---------------------------------------------------------
    def start(self, sched) -> None:
        # A stop()/close() issued BEFORE startup (e.g. a supervisor that
        # decides at launch the run should quiesce after one pass) must
        # survive into the run: never clear _stop here, and downgrade a
        # pre-scheduler close() to a stop request so the connector still
        # performs its initial read, then exits and closes its source
        # properly now that a scheduler is attached. Done under _time_mutex
        # so a concurrent close() can't interleave between the check and
        # the downgrade.
        with self._time_mutex:
            self._sched = sched
            if self._closed and not self._sched_closed:
                self._closed = False
                self._stop.set()
        self._persist_error = None
        if (
            self._persistence is not None
            and self.persistent_id is not None
            and self._persistence.do_replay
        ):
            # replay-then-resume (reference connectors/mod.rs:296-425):
            # emit the consolidated snapshot at one fresh commit time, seek
            # the reader past logged data, then read realtime updates
            rows, offset = self._persistence.rewind(self.persistent_id)
            if offset is not None:
                self.seek_offset(offset)
            if rows:
                self.on_replay(rows)
            if rows and self._persistence.replay_inputs:
                with self._time_mutex:
                    t = next_commit_time()
                    self.emit(t, rows)
                    self.advance(t + 1)
            if not self._persistence.continue_after_replay:
                self.close()
                return
        self._thread = threading.Thread(target=self._run_safe, daemon=True)
        self._thread.start()
        if self.heartbeat_ms is not None:
            self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        from pathway_tpu_torch.engine.clock import wait_heartbeat

        interval = (self.heartbeat_ms or 500) / 1000.0
        gen = 0
        # bind to THIS run's scheduler: stop() may be followed immediately
        # by reset_after_run() (clearing _stop) and a fresh start(), so a
        # parked thread that wakes late must not adopt the next run
        sched = self._sched
        while True:
            # woken early by engine kicks (deferred UDF results landing)
            # so injected times aren't parked behind this source's idle
            # frontier for a whole heartbeat interval
            gen = wait_heartbeat(gen, interval)
            if self._stop.is_set():
                return
            with self._time_mutex:
                if self._closed or self._sched is not sched:
                    return
                self.advance(next_commit_time() + 1)

    def _run_safe(self):
        try:
            self.run()
        except Exception as exc:  # noqa: BLE001
            from pathway_tpu_torch.internals.errors import get_global_error_log

            get_global_error_log().log(f"connector error: {exc!r}")
        finally:
            self.close()

    def run(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        from pathway_tpu_torch.engine.clock import kick_heartbeats

        self._stop.set()
        kick_heartbeats()  # wake a parked heartbeat so it sees the stop
        if self._thread is not None:
            self._thread.join(timeout=10)

    def reset_after_run(self) -> None:
        """Called by the runner after teardown: stop/close requests consumed
        by the finished run are cleared so a subsequent ``pw.run()`` on the
        same graph streams afresh. Requests issued AFTER this point (before
        the next run starts) survive into it — that is the crash-recovery
        pre-start-quiesce path."""
        with self._time_mutex:
            self._stop.clear()
            self._closed = False
            self._sched_closed = False
            self._sched = None
            self._thread = None
            self._hb_thread = None
            # a later run without a persistence config logs nothing
            self._persistence = None
            self._snapshot_writer = None


# the commit clock lives in engine/clock.py (deferred-UDF drains share it);
# re-exported here under its historical name
from pathway_tpu_torch.engine.clock import next_commit_time  # noqa: E402,F401


class StaticStreamConnector(BaseConnector):
    """Replays rows with explicit logical times (markdown ``__time__``)."""

    def __init__(self, node: Node, rows: list[tuple[int, tuple, int, int]], cols):
        super().__init__(node)
        # rows: (key, row, time, diff)
        self.rows = rows

    def run(self):
        by_time: dict[int, list] = {}
        for key, row, t, diff in self.rows:
            by_time.setdefault(t, []).append((key, row, diff))
        for t in sorted(by_time):
            self.emit(t, by_time[t])
            self.advance(t + 1)


class CallbackConnector(BaseConnector):
    """Adapts a generator of (rows, advance_hint) into commits — used by
    demo streams and the Python ConnectorSubject."""

    heartbeat_ms = 500

    def __init__(self, node: Node, generator: Callable, autocommit_ms: int | None):
        super().__init__(node)
        self.generator = generator
        self.autocommit_ms = autocommit_ms

    def run(self):
        for rows in self.generator(self):
            # commit the batch already pulled even when a stop arrived, so a
            # pre-start quiesce still emits one pass (fs-connector contract)
            self.commit_rows(rows)
            if self.should_stop():
                break
