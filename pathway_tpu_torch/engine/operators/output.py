"""Output-side operators: capture, subscribe, connector sinks.

Reference parity: ``output_table``/``subscribe_table`` (dataflow.rs:3542,3645)
with per-time consolidated batches (``ConsolidateForOutput``).
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.engine.state import TableState


class CaptureNode(Node):
    """Materializes the final table (used by debug/compute-and-print paths
    and as the engine's ``ExportedTable``)."""


    def __init__(self, graph, input_node, name="Capture"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.state = TableState(input_node.column_names)
        self.updates: list[tuple[int, Batch]] = []

    def reset(self):
        self.state = TableState(self.column_names)
        self.updates = []

    def step(self, time, ins):
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        self._maybe_terminate_on_error(batch)
        self.state.apply(batch)
        self.updates.append((time, batch))
        return batch

    def _maybe_terminate_on_error(self, batch) -> None:
        maybe_terminate_on_error(batch)


def maybe_terminate_on_error(batch) -> None:
    """Reference semantics (src/engine/error.rs DataError::ErrorInOutput):
    ERROR values propagate through the dataflow as sentinels, but one
    reaching any output (capture, sink, subscribe) aborts the run unless
    terminate_on_error=False."""
    from pathway_tpu_torch.engine.value import ERROR
    from pathway_tpu_torch.internals import config as config_mod

    if not config_mod.active().terminate_on_error:
        return
    # column-major scan: dense numeric columns can never hold the ERROR
    # sentinel (an object) and are skipped whole — the per-row tuple walk
    # paid a Python-level pass over every cell of every output batch
    found = False
    for col in batch.cols.values():
        if col.dtype != object:
            continue
        if any(v is ERROR for v in col.tolist()):
            found = True
            break
    if found:
        from pathway_tpu_torch.internals.errors import (
            EngineError,
            get_global_error_log,
        )

        entries = get_global_error_log().entries
        detail = entries[-1]["message"] if entries else "ERROR value"
        raise EngineError(
            f"error value reached output table ({detail}); set "
            "terminate_on_error=False or use pw.fill_error(...) to "
            "tolerate it"
        )


class SubscribeNode(Node):
    """Calls back per delta row, per time flush and at end-of-stream.

    With ``EngineConfig.columnar_subscribe`` (default on) the per-row
    formatting — Pointer wrapping, dict packaging, the skip-errors scan —
    runs on a per-node background formatter thread fed one columnar
    ``(time, batch)`` block per epoch (the reference's per-batch output
    formatter threads, dataflow.rs:3579-3617). The scheduler thread's cost
    per epoch drops to one queue put; per-row callback ORDER is unchanged
    because one thread drains blocks in epoch order. ``on_time_end`` /
    ``on_end`` callbacks ride the same queue, so their ordering relative
    to row callbacks is also preserved; :meth:`finish` (called by the
    runner before ``pw.run`` returns) flushes the queue, so every callback
    lands before the run completes. A callback exception is re-raised on
    the engine thread at the next step or at finish."""


    def __init__(
        self,
        graph,
        input_node,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
        skip_errors: bool = True,
        name="Subscribe",
    ):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.on_change = on_change
        self.on_time_end_cb = on_time_end
        self.on_end_cb = on_end
        self.skip_errors = skip_errors
        self._saw_data_at: int | None = None
        # set from the run's config at reset (run start), never mid-run:
        # flipping mid-run would interleave inline and queued callbacks
        self._columnar = False
        self._fmt_queue = None
        self._fmt_thread = None
        self._fmt_error: BaseException | None = None

    def _format_rows(self, time, batch) -> None:
        from pathway_tpu_torch.engine.value import ERROR, Pointer

        names = self.column_names
        on_change = self.on_change
        skip = self.skip_errors
        for key, row, diff in batch.rows():
            if skip and any(v is ERROR for v in row):
                continue
            on_change(Pointer(key), dict(zip(names, row)), time, diff > 0)

    # ---- background formatter ------------------------------------------
    def _ensure_formatter(self):
        import queue
        import threading

        if self._fmt_thread is None or not self._fmt_thread.is_alive():
            self._fmt_queue = queue.Queue()
            self._fmt_thread = threading.Thread(
                target=self._fmt_loop,
                args=(self._fmt_queue,),
                daemon=True,
                name=f"pathway:subscribe:{self.name}",
            )
            self._fmt_thread.start()
        return self._fmt_queue

    def _fmt_loop(self, q):
        while True:
            item = q.get()
            if item is None:
                return
            kind, time, batch = item
            try:
                if kind == 0:
                    self._format_rows(time, batch)
                else:
                    self.on_time_end_cb(time)
            except BaseException as exc:  # noqa: BLE001 - re-raised on engine
                self._fmt_error = exc
                return

    def _raise_if_failed(self):
        if self._fmt_error is not None:
            exc, self._fmt_error = self._fmt_error, None
            self._fmt_thread = None
            self._fmt_queue = None
            raise exc

    def _flush_formatter(self):
        """Join the formatter so every queued callback has run."""
        t = self._fmt_thread
        if t is not None and t.is_alive():
            self._fmt_queue.put(None)
            t.join()
        self._fmt_thread = None
        self._fmt_queue = None
        self._raise_if_failed()

    def step(self, time, ins):
        (batch,) = ins
        self._saw_data_at = time
        if batch is not None and len(batch) > 0 and self.on_change is not None:
            if self._columnar:
                self._raise_if_failed()
                self._ensure_formatter().put((0, time, batch))
            else:
                self._format_rows(time, batch)
        return batch

    def on_time_end(self, time):
        if self.on_time_end_cb is not None:
            if self._columnar and self._fmt_thread is not None:
                self._raise_if_failed()
                self._fmt_queue.put((1, time, None))
            else:
                self.on_time_end_cb(time)
        return []

    def finish(self):
        self._flush_formatter()
        if self.on_end_cb is not None:
            self.on_end_cb()

    def reset(self):
        # drop the previous run's formatter (and any error it died on):
        # engine graphs are re-runnable and a stale thread must not leak
        t = self._fmt_thread
        if t is not None and t.is_alive():
            self._fmt_queue.put(None)
            t.join(timeout=5)
        self._fmt_thread = None
        self._fmt_queue = None
        self._fmt_error = None
        from pathway_tpu_torch.internals import config as config_mod

        self._columnar = (
            config_mod.active().columnar_subscribe and self.on_change is not None
        )


class SinkNode(Node):
    """Feeds consolidated batches to a writer callable (I/O connectors)."""

    def __init__(self, graph, input_node, write_batch: Callable, name="Sink"):
        super().__init__(graph, [input_node], input_node.column_names, name)
        self.write_batch = write_batch

    def step(self, time, ins):
        (batch,) = ins
        if batch is not None and len(batch) > 0:
            maybe_terminate_on_error(batch)
            self.write_batch(time, batch)
        return batch

    def finish(self) -> None:
        """End-of-run flush hook (writers with background queues)."""
        flush = getattr(self.write_batch, "finish", None)
        if flush is not None:
            flush()
