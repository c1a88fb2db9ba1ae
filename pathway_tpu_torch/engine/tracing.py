"""Per-request serving spans (counterpart of
``pathway_tpu/engine/tracing.py``).

A :class:`Span` is one request's timeline through a serving loop: a
monotonic start plus timestamped events (``enqueue`` implicitly at
construction, then ``admit``, ``prefix_match``, ``prefill_chunk``,
``spec_cycles``, ``decode_chunk``, ``first_token``, ``drain``), attached
by the continuous decoder server (``xpacks/llm/llms.py``) and the ingest
pipeline (``models/embedder.py``). :meth:`Span.finish` derives queue wait
(admit - enqueue), TTFT (first_token - enqueue), TPOT ((drain -
first_token) / (tokens - 1)) and e2e (drain - enqueue), feeds them into
the registry histograms of ``engine/probes.py`` with the span's ``kind``
as the ``phase`` label, and records the serialized span in two sinks:

* a bounded in-process ring (:func:`configure`'s ``ring``, 256 spans by
  default, oldest evicted) behind :func:`recent_traces`;
* a JSONL flight recorder when :func:`configure` is given a
  ``trace_dir``: one line per span appended to ``trace-<pid>.jsonl``
  through one buffered handle per process, flushed every 32 spans and by
  :func:`flush_traces` (server shutdown and ``atexit``);
* the OpenTelemetry exporter (``internals/telemetry.py``) when a collector
  endpoint is set (``pw.set_monitoring_config(server_endpoint=...)``):
  each finished span becomes one ``pathway_tpu.<kind>`` span with JAX's
  ``pathway_tpu.*`` attributes and its events.

With metrics off (``probes.set_metrics(False)``) :func:`start_span`
returns the shared :data:`NULL_SPAN`, whose methods do nothing. Spans
never touch a tensor.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import time
from collections import deque

from pathway_tpu_torch.analysis.runtime import make_lock
from pathway_tpu_torch.engine import probes

__all__ = [
    "Span", "NULL_SPAN", "start_span", "recent_traces", "reset_traces",
    "flush_traces", "configure",
]


class _NullSpan:
    """Stand-in while metrics are off: every span method is a no-op."""

    __slots__ = ()

    def event(self, name: str, **attrs) -> None:
        pass

    def finish(self, **attrs) -> None:
        return None


NULL_SPAN = _NullSpan()

# lock-discipline declaration for module globals (analyzer rule GL401):
# the span ring, the flight recorder's file-handle state and the lazy
# telemetry singleton may only be touched under their locks
_GUARDED_BY = {
    "_ring": "_ring_lock",
    "_jsonl_file": "_jsonl_lock",
    "_jsonl_path": "_jsonl_lock",
    "_jsonl_unflushed": "_jsonl_lock",
    "_telemetry": "_telemetry_lock",
}

_ids = itertools.count(1)
_ring_lock = make_lock("tracing.ring", rlock=True)
_ring: deque = deque()
_ring_limit = 256
_trace_dir: str | None = None


def configure(ring: int = 256, trace_dir: str | None = None) -> None:
    """Set the ring's size (completed spans kept, at least 1) and the
    flight recorder's directory (None: no recorder). The defaults are the
    JAX package's ``PATHWAY_TPU_TRACE_RING`` / ``PATHWAY_TPU_TRACE_DIR``
    defaults."""
    global _ring_limit, _trace_dir
    _ring_limit = max(1, int(ring))
    _trace_dir = trace_dir or None


class Span:
    """One request's event timeline. A single producer thread appends at a
    time (the submit thread hands off to the loop thread at admission),
    and :meth:`finish` is idempotent."""

    __slots__ = ("kind", "request_id", "server", "attrs", "t0", "wall0",
                 "events", "_finished")

    def __init__(self, kind: str, request_id, server: str | None, attrs: dict):
        self.kind = kind
        self.request_id = request_id
        self.server = server
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.events: list = [("enqueue", self.t0, None)]
        self._finished = False

    def event(self, name: str, **attrs) -> None:
        self.events.append((name, time.perf_counter(), attrs or None))

    def first_t(self, name: str) -> float | None:
        for n, t, _ in self.events:
            if n == name:
                return t
        return None

    def finish(self, **attrs) -> dict | None:
        """Close the span: derive the latency metrics, feed the registry
        histograms (phase = span kind) and record the serialized span.
        Only the first call does anything."""
        if self._finished:
            return None
        self._finished = True
        if attrs:
            self.attrs = {**self.attrs, **attrs}
        end = self.events[-1][1]
        t_admit = t_first = t_drain = t_migrate = None  # first occurrence
        for n, t, _ in self.events:
            if n == "admit":
                if t_admit is None:
                    t_admit = t
            elif n == "first_token":
                if t_first is None:
                    t_first = t
            elif n == "drain" and t_drain is None:
                t_drain = t
            elif n == "migrate" and t_migrate is None:
                t_migrate = t
        if t_drain is None:
            t_drain = end
        tokens = self.attrs.get("tokens")

        metrics: dict = {"e2e_ms": round((t_drain - self.t0) * 1e3, 3)}
        probes.observe_latency("e2e_seconds", t_drain - self.t0, self.kind)
        if t_admit is not None:
            metrics["queue_wait_ms"] = round((t_admit - self.t0) * 1e3, 3)
            probes.observe_latency("queue_wait_seconds", t_admit - self.t0, self.kind)
        if t_admit is not None and t_migrate is not None:
            metrics["prefill_ms"] = round((t_migrate - t_admit) * 1e3, 3)
        if t_first is not None:
            metrics["ttft_ms"] = round((t_first - self.t0) * 1e3, 3)
            probes.observe_latency("ttft_seconds", t_first - self.t0, self.kind)
            if isinstance(tokens, int) and tokens > 1:
                tpot = (t_drain - t_first) / (tokens - 1)
                metrics["tpot_ms"] = round(tpot * 1e3, 3)
                probes.observe_latency("tpot_seconds", tpot, self.kind)

        span_dict = {
            "kind": self.kind,
            "id": self.request_id,
            "server": self.server,
            "start_unix": round(self.wall0, 6),
            "attrs": self.attrs,
            "metrics": metrics,
            "events": [
                {"name": n, "t_ms": round((t - self.t0) * 1e3, 3), **(a or {})}
                for n, t, a in self.events
            ],
        }
        _record(span_dict)
        return span_dict


def start_span(kind: str, request_id=None, server: str | None = None, **attrs):
    """A live :class:`Span` (enqueue stamped now), or :data:`NULL_SPAN`
    with metrics off. ``kind`` becomes the histogram ``phase`` label
    (``decode`` / ``embed``); ``server`` tags the span for
    :func:`recent_traces`."""
    if not probes.REGISTRY.enabled:
        return NULL_SPAN
    if request_id is None:
        request_id = next(_ids)
    return Span(kind, request_id, server, dict(attrs))


def recent_traces(server: str | None = None, kind: str | None = None,
                  n: int | None = None) -> list[dict]:
    """Most recent completed spans (oldest first), optionally filtered by
    the ``server`` tag and/or span ``kind``, truncated to the last ``n``."""
    with _ring_lock:
        spans = list(_ring)
    if server is not None:
        spans = [s for s in spans if s.get("server") == server]
    if kind is not None:
        spans = [s for s in spans if s.get("kind") == kind]
    return spans[-n:] if n else spans


def reset_traces() -> None:
    with _ring_lock:
        _ring.clear()


def _record(span_dict: dict) -> None:
    with _ring_lock:
        _ring.append(span_dict)
        while len(_ring) > _ring_limit:
            _ring.popleft()
    trace_dir = _trace_dir
    if trace_dir:
        _write_jsonl(trace_dir, span_dict)
    _export_otel(span_dict)


# flight-recorder file state: one buffered append handle per process,
# reopened when the directory changes, flushed every _JSONL_FLUSH_EVERY
# spans (bounding what an abrupt kill drops) and drained by flush_traces
_JSONL_FLUSH_EVERY = 32
_jsonl_lock = make_lock("tracing.jsonl", rlock=True)
_jsonl_file = None
_jsonl_path: str | None = None
_jsonl_unflushed = 0


def _write_jsonl(trace_dir: str, span_dict: dict) -> None:
    global _jsonl_file, _jsonl_path, _jsonl_unflushed
    try:
        line = json.dumps(span_dict, default=str)
        path = os.path.join(trace_dir, f"trace-{os.getpid()}.jsonl")
        with _jsonl_lock:
            if _jsonl_file is None or _jsonl_path != path:
                if _jsonl_file is not None:
                    try:
                        _jsonl_file.close()
                    except Exception:  # noqa: BLE001
                        pass
                os.makedirs(trace_dir, exist_ok=True)
                _jsonl_file = open(path, "a", encoding="utf-8")
                _jsonl_path = path
                _jsonl_unflushed = 0
            _jsonl_file.write(line + "\n")
            _jsonl_unflushed += 1
            if _jsonl_unflushed >= _JSONL_FLUSH_EVERY:
                _jsonl_file.flush()
                _jsonl_unflushed = 0
    except Exception:  # noqa: BLE001 - the recorder must never break serving
        pass


def flush_traces(close: bool = True) -> None:
    """Write the flight recorder's buffered lines to disk; with ``close``
    (the default) also release the file handle. Safe to call any number of
    times, from any thread, with or without a recorder."""
    global _jsonl_file, _jsonl_path, _jsonl_unflushed
    with _jsonl_lock:
        f = _jsonl_file
        if f is None:
            return
        try:
            f.flush()
        except Exception:  # noqa: BLE001 - never break shutdown
            pass
        _jsonl_unflushed = 0
        if close:
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
            _jsonl_file = None
            _jsonl_path = None


atexit.register(flush_traces)


# the exporter's Telemetry, built lazily for the configured endpoint
_telemetry = None
_telemetry_lock = make_lock("tracing.telemetry")


def _get_telemetry():
    """Lazy per-endpoint ``Telemetry``; rebuilt if the configured
    collector endpoint changes. None when no endpoint is set."""
    global _telemetry
    from pathway_tpu_torch.internals import config

    endpoint = config.monitoring_server
    if not endpoint:
        return None
    with _telemetry_lock:
        if _telemetry is None or _telemetry.endpoint != endpoint:
            from pathway_tpu_torch.internals.telemetry import Telemetry

            _telemetry = Telemetry(endpoint)
        return _telemetry


def _export_otel(span_dict: dict) -> None:
    tel = _get_telemetry()
    if tel is None or not tel.enabled:
        return
    try:
        attributes = {
            "pathway_tpu.request_id": str(span_dict["id"]),
            "pathway_tpu.server": str(span_dict.get("server")),
            **{f"pathway_tpu.{k}": v
               for k, v in span_dict["metrics"].items()},
        }
        with tel.span(f"pathway_tpu.{span_dict['kind']}", attributes):
            for e in span_dict["events"]:
                tel.event(e["name"], {"t_ms": e["t_ms"]})
    except Exception:  # noqa: BLE001 - export must never break serving
        pass
