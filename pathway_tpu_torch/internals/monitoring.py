"""Monitoring levels and the live console dashboard (counterpart of
``pathway_tpu/internals/monitoring.py``; reference ``StatsMonitor:165``).

``MonitoringLevel`` is the JAX package's enum, member for member.
``resolve_level`` resolves ``None`` / ``AUTO`` / ``AUTO_ALL`` against
standard error's terminal state, as JAX does (``NONE`` off a terminal).
:func:`maybe_start_monitor`, which ``pw.run(monitoring_level=...)`` calls,
starts :class:`StatsMonitor` for any other level: a ``rich`` Live table on
a background thread, fed by the scheduler's ``SchedulerStats`` (connector
ingest counters, per-operator rows and time) with the per-operator
telemetry and serving panels of ``engine/probes`` under it. ``rich`` is
imported when a dashboard starts, never at import.
"""

from __future__ import annotations

import enum
import threading

class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


def resolve_level(level) -> MonitoringLevel:
    """``level`` (a member, its name, or None) resolved against standard
    error's terminal state, as JAX's ``maybe_start_monitor`` does: None
    and the AUTO levels mean NONE off a terminal."""
    import sys

    if isinstance(level, str):
        level = MonitoringLevel[level.upper()]
    if level is None or level in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL):
        if not sys.stderr.isatty():
            return MonitoringLevel.NONE
        return (MonitoringLevel.ALL if level == MonitoringLevel.AUTO_ALL
                else MonitoringLevel.IN_OUT)
    return level


class StatsMonitor:
    """Background renderer of scheduler stats (reference ``StatsMonitor``)."""

    def __init__(self, stats, level: MonitoringLevel, refresh_s: float = 1.0):
        self.stats = stats
        self.level = level
        self.refresh_s = refresh_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- render
    def _serving_panel(self, serving: dict | None = None):
        """Serving metrics (from the unified registry snapshot) as a rich
        table, or None when nothing has been recorded yet."""
        from rich.table import Table as RichTable

        if serving is None:
            from pathway_tpu_torch.engine import probes

            serving = probes.serving_snapshot()
        occupancy = serving.get("occupancy") or {}
        prefix = serving.get("prefix") or {}
        spec = serving.get("spec") or {}
        latency = serving.get("latency") or {}
        lanes = serving.get("lanes") or {}
        tenants = serving.get("tenants") or {}
        ttft = latency.get("ttft_seconds") or {}
        rows: list[tuple[str, str]] = []
        for server, occ in sorted(occupancy.items()):
            rows.append((f"occupancy {server}", f"{occ:.2f}"))
        for lane, n in sorted(lanes.items()):
            rows.append((f"lane {lane}", f"{n:.0f}"))
        for tenant, depth in sorted(tenants.items()):
            rows.append((f"tenant {tenant} queued", f"{depth:.0f}"))
        for server, nbytes in sorted(
            (serving.get("kv_parked_bytes") or {}).items()
        ):
            if nbytes:
                rows.append(
                    (f"kv parked {server}", f"{nbytes / 1e6:.2f} MB")
                )
        if (prefix.get("counts") or {}).get("requests"):
            rows.append(("prefix hit rate", f"{prefix['hit_rate']:.2%}"))
            rows.append(
                ("prefill tokens saved", str(prefix["prefill_tokens_saved"]))
            )
            if prefix.get("t2_lookups"):
                rows.append(
                    ("prefix t2 hit rate", f"{prefix['hit_rate_t2']:.2%}")
                )
        if spec.get("acceptance_rate"):
            rows.append(("spec acceptance", f"{spec['acceptance_rate']:.2%}"))
            rows.append(
                ("tokens / dispatch", f"{spec['tokens_per_dispatch']:.2f}")
            )
        if ttft:
            rows.append(("TTFT p50", f"{ttft['p50_ms']:.1f} ms"))
            rows.append(("TTFT p95", f"{ttft['p95_ms']:.1f} ms"))
        for backend, n in sorted((serving.get("retrieval") or {}).items()):
            rows.append((f"retrieval {backend}", str(int(n))))
        from pathway_tpu_torch.engine import probes as _probes

        hbm = _probes.hbm_stats()
        # per-device HBM rows (PATHWAY_TPU_MESH): single-chip shows one
        # device "0" row; a mesh shows one row per device so the panel
        # surfaces the TIGHTEST device, not just the fleet aggregate
        for dev, nbytes in sorted(
            (hbm.get("per_device_bytes") or {}).items()
        ):
            if nbytes:
                rows.append((f"hbm device {dev}", f"{nbytes / 1e6:.2f} MB"))
        # model-weight components (weights.decoder / .embedder /
        # .reranker): one row per model, beside the KV pool
        for comp, nbytes in sorted(
            (hbm.get("current_bytes") or {}).items()
        ):
            if nbytes and comp.startswith("weights."):
                rows.append((f"hbm {comp}", f"{nbytes / 1e6:.2f} MB"))
        if not rows:
            return None
        panel = RichTable(title="serving")
        panel.add_column("metric")
        panel.add_column("value", justify="right")
        for k, v in rows:
            panel.add_row(k, v)
        return panel

    def _engine_panel(self, engine: dict | None = None):
        """Per-operator registry telemetry (latency quantiles, rows,
        held backlog, watermark lag) as a rich table, or None while the
        telemetry families are empty (kill switch off, or no epochs
        yet)."""
        from rich.table import Table as RichTable

        if engine is None:
            from pathway_tpu_torch.engine import probes

            engine = probes.engine_snapshot()
        ops = engine.get("operators") or {}
        if not ops:
            return None
        held = engine.get("held_rows") or {}
        lag = engine.get("watermark_lag") or {}
        panel = RichTable(title="per-operator telemetry")
        panel.add_column("operator")
        panel.add_column("steps", justify="right")
        panel.add_column("p50 [ms]", justify="right")
        panel.add_column("p95 [ms]", justify="right")
        panel.add_column("rows in", justify="right")
        panel.add_column("rows out", justify="right")
        panel.add_column("held", justify="right")
        panel.add_column("wm lag", justify="right")
        for name, o in ops.items():
            panel.add_row(
                name,
                str(o["steps"]),
                f"{o['p50_ms']:.2f}",
                f"{o['p95_ms']:.2f}",
                str(o["rows_in"]),
                str(o["rows_out"]),
                str(held.get(name, "-")),
                f"{lag[name]:.1f}" if name in lag else "-",
            )
        backlog = engine.get("backlog") or {}
        if backlog:
            panel.caption = "backlog: " + ", ".join(
                f"{k}={v}" for k, v in sorted(backlog.items())
            )
        return panel

    def _render_dashboard(self):
        """Operator table plus, when telemetry exists, the per-operator
        and serving panels — what the live loop actually displays."""
        from rich.console import Group

        table = self._render()
        panels = [
            p for p in (self._engine_panel(), self._serving_panel())
            if p is not None
        ]
        return table if not panels else Group(table, *panels)

    def _render(self):
        from rich.table import Table as RichTable

        snap = self.stats.snapshot()
        table = RichTable(title="pathway-tpu progress dashboard")
        table.add_column("operator")
        table.add_column("rows in", justify="right")
        table.add_column("rows out", justify="right")
        table.add_column("epochs", justify="right")
        table.add_column("time [s]", justify="right")
        for c in snap["connectors"]:
            table.add_row(
                f"[cyan]{c['name']}[/cyan]",
                str(c["rows_read"]),
                "-",
                str(c["commits"]),
                "done" if c["finished"] else "live",
            )
        ops = snap["operators"]
        if self.level != MonitoringLevel.ALL:
            # IN_OUT: endpoints only, like the reference's default dashboard
            ops = [
                o
                for o in ops
                if any(
                    k in o["name"].lower()
                    for k in ("input", "output", "capture", "subscribe", "connector")
                )
            ]
        for o in ops:
            table.add_row(
                o["name"],
                str(o["rows_in"]),
                str(o["rows_out"]),
                str(o["epochs"]),
                f"{o['total_time_s']:.3f}",
            )
        table.caption = (
            f"logical time {snap['current_time']}, "
            f"{snap['epochs_total']} epochs, up {snap['uptime_s']:.1f}s"
        )
        return table

    def _loop(self) -> None:
        from rich.live import Live

        with Live(
            self._render_dashboard(), refresh_per_second=4, transient=False
        ) as live:
            while not self._stop.wait(self.refresh_s):
                live.update(self._render_dashboard())
            live.update(self._render_dashboard())

    # ---------------------------------------------------------------- control
    def start(self) -> None:
        if self.level == MonitoringLevel.NONE:
            return
        self._thread = threading.Thread(
            target=self._loop, name="pathway-tpu:monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def maybe_start_monitor(stats, level) -> StatsMonitor | None:
    """Start a dashboard when the level (after AUTO resolution against
    standard error's terminal state) asks for one; returns None otherwise.
    The dashboard needs ``rich``: a level that asks for it without
    ``rich`` installed raises ``ImportError`` (no plain-text fallback)."""
    resolved = resolve_level(level)
    if resolved == MonitoringLevel.NONE:
        return None
    try:
        import rich.live  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            f"pw.run(monitoring_level={level!r}) draws the live dashboard with the "
            "'rich' package, which is not installed; install it or pass "
            "monitoring_level=pw.MonitoringLevel.NONE") from exc
    monitor = StatsMonitor(stats, resolved)
    monitor.start()
    return monitor
