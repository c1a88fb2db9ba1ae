"""OpenMetrics text of the port's metrics registry and the per-process
metrics server (counterpart of ``pathway_tpu/internals/http_server.py``;
reference ``src/engine/http_server.rs:25-215``).

:func:`registry_text` renders ``engine/probes.REGISTRY`` (counters,
gauges and the serving latency histograms) as OpenMetrics families under
the ``pathway_tpu_`` prefix, the names the JAX package exposes;
:func:`openmetrics_text` is that text plus the ``# EOF`` terminator, what
the REST servers' ``/metrics`` route serves. :func:`metrics_from_stats`
renders a scheduler's ``SchedulerStats`` snapshot (logical time, epochs,
per-operator rows and time, per-connector reads) as Prometheus gauges.
:class:`MetricsServer`, which ``pw.run(with_http_server=True)`` starts,
serves both on port ``20000 + process_id`` with the ``/healthz`` and
``/readyz`` probes, on the standard library's ``http.server``.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pathway_tpu_torch.engine import probes

BASE_PORT = 20000

_PREFIX = "pathway_tpu_"


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels_text(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def registry_text(snapshot: dict | None = None) -> str:
    """A ``MetricsRegistry`` snapshot (the live one by default) as
    OpenMetrics text without ``# EOF``. Every family of
    ``probes.METRIC_FAMILIES`` gets its HELP/TYPE lines even before its
    first sample."""
    snap = snapshot if snapshot is not None else probes.REGISTRY.snapshot()
    counters, gauges, hists = snap["counters"], snap["gauges"], snap["histograms"]
    names = sorted(set(probes.METRIC_FAMILIES) | set(counters) | set(gauges) | set(hists))
    lines: list[str] = []
    for name in names:
        kind, _, help_text = probes.METRIC_FAMILIES.get(
            name,
            ("histogram" if name in hists else "gauge" if name in gauges else "counter",
             None, name.replace("_", " ")),
        )
        full = _PREFIX + name
        lines.append(f"# HELP {full} {help_text}")
        lines.append(f"# TYPE {full} {kind}")
        if kind == "counter":
            for s in counters.get(name, {}).get("series", []):
                lines.append(f"{full}_total{_labels_text(s['labels'])} {_num(s['value'])}")
        elif kind == "gauge":
            for s in gauges.get(name, {}).get("series", []):
                lines.append(f"{full}{_labels_text(s['labels'])} {_num(s['value'])}")
        else:
            fam = hists.get(name)
            if fam is None:
                continue
            bounds = fam["bounds"]
            for s in fam["series"]:
                cum = 0
                for i, c in enumerate(s["buckets"]):
                    cum += c
                    le = format(bounds[i], "g") if i < len(bounds) else "+Inf"
                    lines.append(f"{full}_bucket{_labels_text(s['labels'], {'le': le})} {cum}")
                lines.append(f"{full}_sum{_labels_text(s['labels'])} {repr(float(s['sum']))}")
                lines.append(f"{full}_count{_labels_text(s['labels'])} {s['count']}")
    return "\n".join(lines) + "\n"


def openmetrics_text(snapshot: dict | None = None) -> str:
    """The full exposition: :func:`registry_text` and ``# EOF``."""
    return registry_text(snapshot) + "# EOF\n"


def metrics_from_stats(snapshot: dict) -> str:
    """A ``SchedulerStats`` snapshot as Prometheus gauges (JAX's names)."""
    lines: list[str] = []
    seen_help: set[str] = set()

    def gauge(name: str, value, help_text: str, labels: str = "") -> None:
        if name not in seen_help:
            seen_help.add(name)
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {value}")

    gauge("pathway_logical_time", snapshot["current_time"], "Current committed logical time")
    gauge("pathway_epochs_total", snapshot["epochs_total"], "Epochs processed since start")
    gauge("pathway_uptime_seconds", f"{snapshot['uptime_s']:.3f}",
          "Seconds since the run started")
    gauge("pathway_run_finished", int(snapshot["finished"]), "Whether the dataflow has finished")
    for op in snapshot["operators"]:
        label = '{operator="%s"}' % op["name"].replace('"', "'")
        gauge("pathway_operator_rows_in_total", op["rows_in"], "Rows consumed per operator", label)
        gauge("pathway_operator_rows_out_total", op["rows_out"], "Rows produced per operator",
              label)
        gauge("pathway_operator_time_seconds_total", f"{op['total_time_s']:.6f}",
              "Wall seconds spent per operator", label)
        lag = (max(0.0, time.time() - op["last_active_time"])
               if op["last_active_time"] else 0.0)
        gauge("pathway_operator_lag_seconds", f"{lag:.3f}",
              "Seconds since the operator was last active", label)
    for c in snapshot["connectors"]:
        label = '{connector="%s"}' % c["name"].replace('"', "'")
        gauge("pathway_connector_rows_read_total", c["rows_read"], "Rows ingested per connector",
              label)
        gauge("pathway_connector_commits_total", c["commits"], "Commits per connector", label)
        gauge("pathway_connector_finished", int(c["finished"]),
              "Whether the connector reached end of stream", label)
    return "\n".join(lines) + "\n"


def scrape_text(scheduler_snapshot: dict | None = None) -> str:
    """The metrics server's body: the scheduler gauges (when a snapshot is
    given), then :func:`openmetrics_text`. A scrape drives the SLO
    watchdog's evaluation (rate-limited inside ``maybe_tick``), as in JAX,
    so a deployment watched only through Prometheus is still judged."""
    from pathway_tpu_torch.engine import slo

    wd = slo.get_watchdog()
    if wd.objectives:
        wd.maybe_tick()
    head = metrics_from_stats(scheduler_snapshot) if scheduler_snapshot is not None else ""
    return head + openmetrics_text()


class MetricsServer:
    """Background HTTP server exposing ``/metrics`` (with ``/`` and
    ``/status`` as aliases), plus the health pair deployment probes speak:

    * ``/healthz``: liveness, 200 whenever the server thread answers;
    * ``/readyz``: readiness, 200 once ``ready_check()`` (injected, or "a
      scheduler snapshot exists") says the pipeline serves; 503 with a
      ``Retry-After`` before that.

    ``port=None`` binds ``20000 + process_id`` (JAX's scheme); ``port=0``
    an ephemeral port, read back from :attr:`port` after :meth:`start`.
    """

    def __init__(self, stats, process_id: int = 0, port: int | None = None,
                 ready_check=None, host: str = "127.0.0.1"):
        self.stats = stats
        self.host = host
        self.port = port if port is not None else BASE_PORT + process_id
        self.ready_check = ready_check
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def _ready(self) -> bool:
        try:
            if self.ready_check is not None:
                return bool(self.ready_check())
            return self.stats is not None and self.stats.snapshot() is not None
        except Exception:  # noqa: BLE001 - a failing probe reads as not ready
            return False

    def start(self) -> "MetricsServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, status: int, body: bytes, ctype: str,
                      retry_after: int | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                plain = "text/plain; charset=utf-8"
                if self.path == "/healthz":
                    self._send(200, b"ok\n", plain)
                elif self.path == "/readyz":
                    if outer._ready():
                        self._send(200, b"ready\n", plain)
                    else:
                        self._send(503, b"not ready\n", plain, retry_after=1)
                elif self.path in ("/", "/metrics", "/status"):
                    snap = outer.stats.snapshot() if outer.stats is not None else None
                    self._send(200, scrape_text(snap).encode(), "text/plain; version=0.0.4")
                else:
                    self._send(404, b"not found\n", plain)

            def log_message(self, *args) -> None:
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pathway-tpu:metrics", daemon=True)
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
