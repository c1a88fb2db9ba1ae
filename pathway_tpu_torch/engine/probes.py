"""The port's metrics registry and the ledgers over it (counterpart of
``pathway_tpu/engine/probes.py``).

Every ledger is a thin layer over ONE :class:`MetricsRegistry`
(``REGISTRY``): a thread-safe store of named counters, gauges and
log-bucketed histograms with label sets, as in the JAX package. The
ledgers keep the JAX signatures and return shapes:

* per-request latency histograms (TTFT / TPOT / queue wait / e2e), fed by
  the spans of ``engine/tracing.py``;
* device-dispatch counters (``record_device_dispatch``), called by the
  kernel callers of the embedder, the index and the fused query path;
* the HBM ledger: per-component device bytes from tensor byte counts,
  recorded once at weight placement and pool build;
* attention traffic (an accounting model of bytes per attention call),
  the prefix-cache, speculative-decode, cascade and retrieval-backend
  ledgers, the pipeline-stage timer with :func:`bubble_attribution`, and
  a roofline model against the H100's published peaks;
* the dataflow engine's telemetry: per-operator step latency and rows
  (``record_op_step``), backlog and frontier gauges, held rows and
  watermark lag, ``engine_snapshot``, and the scheduler's own
  ``SchedulerStats`` (with ``engine_tax``).

:func:`set_metrics` is the master switch, on by default as
``PATHWAY_TPU_METRICS`` is in JAX: off, every record call is a no-op and
outputs stay byte-identical. Resets always apply. The port reads no
environment variable; the switch is this module's function.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import threading
import time
import weakref

from pathway_tpu_torch.analysis.annotations import assumes_held, guarded_by
from pathway_tpu_torch.analysis.runtime import make_lock

# H100 SXM5 80 GB, NVIDIA's data sheet: dense bf16 tensor-core peak and
# HBM3 bandwidth (at the full 700 W power limit)
H100_PEAK_BF16_FLOPS = 989.4e12
H100_PEAK_HBM_BYTES = 3.35e12

_metrics_on = True


def set_metrics(enabled: bool = True) -> None:
    """Turn every registry write (counters, gauges, histograms) and every
    new request span on or off. On by default."""
    global _metrics_on
    _metrics_on = bool(enabled)


def metrics_enabled() -> bool:
    return _metrics_on


# --------------------------------------------------------------------- #
# the unified metrics registry

# log-bucketed (factor 2) latency bounds: 100us .. ~105s, 21 buckets +
# one +Inf overflow; interpolated p50/p95 stay within a 2x bucket of the
# truth
_DEFAULT_HIST_BOUNDS = tuple(1e-4 * (2.0 ** i) for i in range(21))

# every family the package emits, so exporters can render HELP/TYPE
# lines even before the first sample (a copy of the JAX table, so the two
# packages expose one surface): name -> (type, label, help)
METRIC_FAMILIES: dict[str, tuple[str, str | None, str]] = {
    "device_dispatch": (
        "counter", "kind", "Accelerator round trips by dispatch kind"),
    "cascade_pairs": (
        "counter", "stage", "Rerank pairs scored per cascade stage"),
    "cascade_flops": (
        "counter", "stage", "Model FLOPs paid per cascade stage"),
    "prefix_events": (
        "counter", "kind", "Prefix-KV-cache events (hit/miss tokens, "
        "requests, inserted/evicted blocks)"),
    "prefix_cached_bytes": (
        "gauge", None, "Resident KV bytes in the prefix arena"),
    "spec_events": (
        "counter", "kind", "Speculative-decode events (drafted/accepted/"
        "emitted tokens, verify/draft steps)"),
    "stage_seconds": (
        "counter", "stage", "Host busy seconds per pipeline stage"),
    "stage_items": (
        "counter", "stage", "Items processed per pipeline stage"),
    "serving_occupancy": (
        "gauge", "server", "Useful slot-steps / total slot-steps of a "
        "continuous decode server"),
    "ttft_seconds": (
        "histogram", "phase", "Time from request enqueue to first "
        "drained token"),
    "tpot_seconds": (
        "histogram", "phase", "Mean time per output token after the "
        "first (per request)"),
    "queue_wait_seconds": (
        "histogram", "phase", "Time from request enqueue to admission"),
    "e2e_seconds": (
        "histogram", "phase", "Time from request enqueue to completion"),
    "op_step_seconds": (
        "histogram", "operator", "Per-operator epoch-processing latency "
        "(one observation per stepped operator per epoch)"),
    "op_rows": (
        "counter", "operator", "Rows entering (direction=in) and leaving "
        "(direction=out) each operator"),
    "op_held_rows": (
        "gauge", "operator", "Rows currently held back by a stateful "
        "temporal operator (buffer backlog / forget liveness set)"),
    "watermark_lag": (
        "gauge", "operator", "Distance (time-column units) between a "
        "temporal operator's watermark and its oldest held threshold"),
    "engine_backlog": (
        "gauge", "queue", "Dataflow backlog depth (pending injected "
        "epochs, async in-flight batches)"),
    "engine_frontier_lag": (
        "gauge", None, "Epochs the source frontier is ahead of the "
        "scheduler's last processed time"),
    "exchange_rows": (
        "counter", "direction", "Rows routed by the exchange layer "
        "(local / sent / received / broadcast)"),
    "hbm_bytes": (
        "gauge", "component", "Current device-memory ledger bytes per "
        "component (slot_pool / prefix_arena / kv_scales / ...)"),
    "hbm_high_water_bytes": (
        "gauge", "component", "High-water device-memory ledger bytes per "
        "component, plus the 'total' series across all components"),
    "slo_burn_rate": (
        "gauge", "objective", "SLO error-budget burn rate per objective "
        "and window (fast / slow)"),
    "slo_alert": (
        "gauge", "objective", "1 while an SLO objective's multi-window "
        "burn-rate alert is firing, else 0"),
    "slo_breaches": (
        "counter", "objective", "SLO alert activations (ok -> firing "
        "transitions) per objective"),
    "serve_restarts": (
        "counter", "server", "Supervised serving-loop restarts "
        "(crash -> backoff -> re-enter) per server"),
    "requests_shed": (
        "counter", "reason", "Requests shed by admission control "
        "(deadline / queue_full / degraded)"),
    "degradation_level": (
        "gauge", None, "Current SLO-driven degradation ladder level "
        "(0 = full service, 3 = shedding low-priority admissions)"),
    "requests_isolated": (
        "counter", "outcome", "Request-scoped serving errors handled by "
        "per-request isolation (retried / failed)"),
    "kv_fragmentation": (
        "gauge", "server", "Fraction of a serving pool's allocated KV "
        "bytes stranded beyond what active requests can reach "
        "(0 = perfectly packed; dense right-padded slots strand the "
        "whole row tail, paged allocation only the final block's)"),
    "kv_parked_bytes": (
        "gauge", "server", "KV bytes held by preempted requests' parked "
        "block rows (held on purpose for re-admission — classified "
        "apart from kv_fragmentation's stranded bytes)"),
    "lane_occupancy": (
        "gauge", "lane", "Slots per serving lane (prefill = mid-prompt, "
        "decode = emitting) of a continuous decode server"),
    "tenant_queue_depth": (
        "gauge", "tenant", "Queued requests per tenant awaiting "
        "weighted-fair admission"),
    "preemptions": (
        "counter", "tenant", "Over-budget requests preempted out of "
        "their slot (KV parked, request requeued) per tenant"),
    "kv_migrated_blocks": (
        "counter", "server", "KV blocks handed from the prefill lane to "
        "the decode lane at prompt completion (PATHWAY_TPU_DISAGG)"),
    "requests_routed": (
        "counter", "replica", "Requests forwarded by the fleet router, "
        "per destination replica"),
    "requests_requeued": (
        "counter", None, "Fleet requests re-dispatched to another "
        "replica after their replica died mid-flight"),
    "ring_moves": (
        "counter", None, "Consistent-hash-ring vnode arcs that changed "
        "owner on replica join/leave"),
    "replica_up": (
        "gauge", "replica", "1 while a fleet replica is a ring member, "
        "0 once drained"),
}

LATENCY_HISTOGRAMS = (
    "ttft_seconds", "tpot_seconds", "queue_wait_seconds", "e2e_seconds",
)


@guarded_by(_counters="_lock", _gauges="_lock", _hists="_lock")
class MetricsRegistry:
    """Single thread-safe registry of counters, gauges and log-bucketed
    histograms, each a family of label-keyed series.

    One lock covers every mutation and the whole :meth:`snapshot`, so a
    snapshot is consistent across families. Writes are gated on
    :func:`set_metrics` (read per call); resets always apply."""

    def __init__(self, hist_bounds: tuple = _DEFAULT_HIST_BOUNDS):
        self._lock = make_lock("probes.registry", rlock=True)
        self.hist_bounds = tuple(float(b) for b in hist_bounds)
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        # name -> labelkey -> [bucket counts (len bounds+1), sum, count]
        self._hists: dict[str, dict[tuple, list]] = {}

    @property
    def enabled(self) -> bool:
        return _metrics_on

    @staticmethod
    def _key(labels: dict) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    # ------------------------------------------------------------ write
    def counter_add(self, name: str, value: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        key = self._key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def counter_add_many(self, name: str, label: str, counts: dict) -> None:
        """Batched :meth:`counter_add` over one label dimension: a single
        enabled check and lock acquisition for a whole group of updates
        (one spec drain flushes six counters)."""
        if not self.enabled:
            return
        with self._lock:
            series = self._counters.setdefault(name, {})
            for lv, v in counts.items():
                key = ((label, str(lv)),)
                series[key] = series.get(key, 0.0) + v

    def gauge_set(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def gauge_add(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = self._key(labels)
        with self._lock:
            series = self._gauges.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = self._key(labels)
        v = float(value)
        with self._lock:
            series = self._hists.setdefault(name, {})
            rec = series.get(key)
            if rec is None:
                rec = series[key] = [[0] * (len(self.hist_bounds) + 1), 0.0, 0]
            rec[0][bisect.bisect_left(self.hist_bounds, v)] += 1
            rec[1] += v
            rec[2] += 1

    def observe_op_step(
        self, operator: str, seconds: float, rows_in: int, rows_out: int
    ) -> None:
        """One stepped operator epoch: latency histogram observation plus
        rows-in/rows-out counters under a SINGLE enabled check + lock
        acquisition — this sits on the scheduler's per-step hot path."""
        if not self.enabled:
            return
        v = float(seconds)
        hkey = (("operator", operator),)
        with self._lock:
            series = self._hists.setdefault("op_step_seconds", {})
            rec = series.get(hkey)
            if rec is None:
                rec = series[hkey] = [
                    [0] * (len(self.hist_bounds) + 1), 0.0, 0,
                ]
            rec[0][bisect.bisect_left(self.hist_bounds, v)] += 1
            rec[1] += v
            rec[2] += 1
            rows = self._counters.setdefault("op_rows", {})
            if rows_in:
                key = (("direction", "in"), ("operator", operator))
                rows[key] = rows.get(key, 0.0) + rows_in
            if rows_out:
                key = (("direction", "out"), ("operator", operator))
                rows[key] = rows.get(key, 0.0) + rows_out

    def gauge_max(self, name: str, value: float, **labels) -> None:
        """Set the gauge to ``max(current, value)``: the high-water
        primitive of the HBM ledger. Atomic under the registry lock."""
        if not self.enabled:
            return
        key = self._key(labels)
        v = float(value)
        with self._lock:
            series = self._gauges.setdefault(name, {})
            cur = series.get(key)
            if cur is None or v > cur:
                series[key] = v

    # ------------------------------------------------------------- read
    def labelled(self, name: str, label: str,
                 kind: str = "counter") -> dict[str, float]:
        """Series values of ``name`` summed by their ``label`` value."""
        with self._lock:
            store = self._counters if kind == "counter" else self._gauges
            items = list((store.get(name) or {}).items())
        out: dict[str, float] = {}
        for key, v in items:
            lv = dict(key).get(label, "")
            out[lv] = out.get(lv, 0.0) + v
        return out

    def gauge_value(self, name: str, **labels) -> float | None:
        with self._lock:
            series = self._gauges.get(name)
            if not series:
                return None
            if labels:
                return series.get(self._key(labels))
            return sum(series.values())

    def hist_summary(self, name: str, **labels) -> dict | None:
        """Merged bucket summary of every series of ``name`` whose labels
        contain ``labels``; quantiles interpolate inside the matched
        bucket. None before the first observation."""
        want = set(self._key(labels)) if labels else None
        merged = [0] * (len(self.hist_bounds) + 1)
        total, s = 0, 0.0
        with self._lock:
            for key, (counts, ssum, cnt) in (self._hists.get(name) or {}).items():
                if want is not None and not want <= set(key):
                    continue
                for i, c in enumerate(counts):
                    merged[i] += c
                s += ssum
                total += cnt
        if not total:
            return None
        return {
            "count": total,
            "sum": s,
            "mean": s / total,
            "p50": self._quantile(merged, 0.5),
            "p95": self._quantile(merged, 0.95),
        }

    def _quantile(self, counts: list, q: float) -> float:
        total = sum(counts)
        if not total:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.hist_bounds[i - 1]
                hi = (self.hist_bounds[i] if i < len(self.hist_bounds)
                      else self.hist_bounds[-1])
                frac = max(0.0, min(1.0, (rank - cum) / c))
                return lo + (hi - lo) * frac
            cum += c
        return self.hist_bounds[-1]

    def remove(self, *names: str) -> None:
        with self._lock:
            for n in names:
                self._counters.pop(n, None)
                self._gauges.pop(n, None)
                self._hists.pop(n, None)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def snapshot(self) -> dict:
        """One consistent plain-dict snapshot of every family (a single
        lock acquisition), for exporters and JSON."""
        def series(store):
            return {n: {"series": [{"labels": dict(k), "value": v}
                                   for k, v in sorted(s.items())]}
                    for n, s in sorted(store.items())}

        with self._lock:
            counters, gauges = series(self._counters), series(self._gauges)
            hists = {
                n: {
                    "bounds": list(self.hist_bounds),
                    "series": [{"labels": dict(k), "buckets": list(rec[0]),
                                "sum": rec[1], "count": rec[2]}
                               for k, rec in sorted(s.items())],
                }
                for n, s in sorted(self._hists.items())
            }
        return {"counters": counters, "gauges": gauges, "histograms": hists}


REGISTRY = MetricsRegistry()


def observe_latency(name: str, seconds: float, phase: str) -> None:
    """One request-latency observation into a registry histogram (``name``
    in :data:`LATENCY_HISTOGRAMS`, ``phase`` = decode / embed). Called by
    ``engine/tracing.py`` span finish."""
    REGISTRY.observe(name, seconds, phase=phase)


def latency_summary(phase: str | None = None) -> dict:
    """Per-histogram ms summaries (count / p50 / p95 / mean), optionally
    of one phase. Families with no observations are omitted."""
    out: dict = {}
    for name in LATENCY_HISTOGRAMS:
        s = REGISTRY.hist_summary(name, **({"phase": phase} if phase else {}))
        if s is not None:
            out[name] = {
                "count": s["count"],
                "p50_ms": round(s["p50"] * 1e3, 3),
                "p95_ms": round(s["p95"] * 1e3, 3),
                "mean_ms": round(s["mean"] * 1e3, 3),
            }
    return out


def reset_latency_metrics() -> None:
    REGISTRY.remove(*LATENCY_HISTOGRAMS)


def _gauges_by(name: str, label: str, digits: int) -> dict:
    return {k: round(v, digits)
            for k, v in REGISTRY.labelled(name, label, kind="gauge").items()}


def serving_snapshot() -> dict:
    """The serving-side view: every ledger in one dict, with the same keys
    as the JAX package's."""
    return {
        "prefix": prefix_stats(),
        "spec": spec_stats(),
        "cascade": cascade_stats(),
        "attn": attn_stats(),
        "dispatch": dispatch_counts(),
        "stage_seconds": {k: round(v, 6) for k, v in sorted(stage_seconds().items())},
        "occupancy": _gauges_by("serving_occupancy", "server", 4),
        "lanes": _gauges_by("lane_occupancy", "lane", 4),
        "tenants": _gauges_by("tenant_queue_depth", "tenant", 4),
        "kv_parked_bytes": _gauges_by("kv_parked_bytes", "server", 1),
        "retrieval": retrieval_backend_stats(),
        "latency": latency_summary(),
    }


def unified_snapshot(scheduler_stats=None) -> dict:
    """Scheduler, serving, the engine's operators, device memory, the SLO
    watchdog's state, the tuned configs loaded in this process and the raw
    registry in one dict. ``scheduler`` is the snapshot of the
    ``SchedulerStats`` the caller passes (a run's
    ``pw.internals.run.LAST_RUN_STATS``; None by default)."""
    from pathway_tpu_torch.engine import slo
    from pathway_tpu_torch.internals.config import tuned_config_snapshot

    sched = scheduler_stats
    if sched is not None and hasattr(sched, "snapshot"):
        sched = sched.snapshot()
    return {
        "scheduler": sched,
        "serving": serving_snapshot(),
        "engine": engine_snapshot(),
        "hbm": hbm_stats(),
        "slo": slo.slo_snapshot(),
        "tuning": tuned_config_snapshot(),
        "registry": REGISTRY.snapshot(),
    }


# --------------------------------------------------------------------- #
# per-operator dataflow telemetry (registry-backed)
#
# The scheduler already times every operator step for SchedulerStats;
# since the observability PR the same measurement also lands in the
# registry — `op_step_seconds{operator=}` histograms and
# `op_rows{operator=,direction=}` counters — so latency DISTRIBUTIONS
# (not just totals) are scrapeable per operator. Temporal operators add
# `op_held_rows` / `watermark_lag` gauges, the scheduler an
# `engine_backlog{queue=}` gauge riding `pending_backlog()`, and the
# exchange layer `exchange_rows{direction=}` counters (empty unless the
# run has several processes). All of it is gated twice: set_metrics
# (master, per call inside the registry) and EngineConfig.op_metrics
# (read once per scheduler construction).

def record_op_step(
    operator: str, seconds: float, rows_in: int, rows_out: int
) -> None:
    """Per-operator epoch record: latency observation + row counters in
    one registry transaction. Called by ``Scheduler._step_node``."""
    REGISTRY.observe_op_step(operator, seconds, rows_in, rows_out)


def record_backlog(queue: str, depth: int) -> None:
    """Backlog depth gauge (``queue`` = pending_epochs / async_inflight /
    drain_group). Throttled by callers — gauges only need freshness, not
    every transition."""
    REGISTRY.gauge_set("engine_backlog", depth, queue=queue)


def record_frontier_lag(lag: float) -> None:
    REGISTRY.gauge_set("engine_frontier_lag", max(0.0, float(lag)))


def record_watermark(operator: str, held_rows: int,
                     lag: float | None) -> None:
    """Temporal-operator state: rows currently held back and, when the
    time column is numeric, how far the oldest held threshold trails the
    watermark."""
    REGISTRY.gauge_set("op_held_rows", held_rows, operator=operator)
    if lag is not None:
        REGISTRY.gauge_set(
            "watermark_lag", max(0.0, float(lag)), operator=operator
        )


def record_exchange(**rows: int) -> None:
    """Exchange-layer row accounting by direction (``local`` / ``sent`` /
    ``received`` / ``broadcast``): one lock acquisition per step."""
    REGISTRY.counter_add_many(
        "exchange_rows", "direction", {k: v for k, v in rows.items() if v}
    )


def engine_snapshot() -> dict:
    """Per-operator registry view: latency quantiles + row counters per
    operator, backlog gauges, watermark lag, exchange counters. The
    'engine' section of :func:`unified_snapshot` and the source of the
    per-operator dashboard panel."""
    snap = REGISTRY.snapshot()
    ops: dict[str, dict] = {}
    for series in snap["histograms"].get("op_step_seconds", {}).get(
        "series", []
    ):
        name = series["labels"].get("operator", "")
        s = REGISTRY.hist_summary("op_step_seconds", operator=name)
        if s is None:
            continue
        ops[name] = {
            "steps": s["count"],
            "p50_ms": round(s["p50"] * 1e3, 3),
            "p95_ms": round(s["p95"] * 1e3, 3),
            "mean_ms": round(s["mean"] * 1e3, 3),
            "rows_in": 0,
            "rows_out": 0,
        }
    for series in snap["counters"].get("op_rows", {}).get("series", []):
        labels = series["labels"]
        op = ops.setdefault(labels.get("operator", ""), {
            "steps": 0, "p50_ms": 0.0, "p95_ms": 0.0, "mean_ms": 0.0,
            "rows_in": 0, "rows_out": 0,
        })
        key = "rows_in" if labels.get("direction") == "in" else "rows_out"
        op[key] = int(series["value"])
    backlog = {
        k: int(v)
        for k, v in REGISTRY.labelled(
            "engine_backlog", "queue", kind="gauge"
        ).items()
    }
    held = {
        k: int(v)
        for k, v in REGISTRY.labelled(
            "op_held_rows", "operator", kind="gauge"
        ).items()
    }
    lag = REGISTRY.labelled("watermark_lag", "operator", kind="gauge")
    frontier = REGISTRY.gauge_value("engine_frontier_lag")
    out: dict = {
        "operators": {k: ops[k] for k in sorted(ops)},
        "backlog": backlog,
        "held_rows": held,
        "watermark_lag": {k: round(v, 6) for k, v in sorted(lag.items())},
        "exchange": {
            k: int(v)
            for k, v in REGISTRY.labelled(
                "exchange_rows", "direction"
            ).items()
        },
    }
    if frontier is not None:
        out["frontier_lag"] = frontier
    summaries = [o["p50_ms"] for o in ops.values() if o.get("steps")]
    out["op_latency_p50_ms"] = (
        round(sum(summaries) / len(summaries), 3) if summaries else 0.0
    )
    return out


def reset_engine_stats() -> None:
    REGISTRY.remove(
        "op_step_seconds", "op_rows", "op_held_rows", "watermark_lag",
        "engine_backlog", "engine_frontier_lag", "exchange_rows",
    )


# --------------------------------------------------------------------- #
# HBM ledger
#
# Current bytes per (component, device, owner), per-component high-water,
# a `total` high-water across components and a per-device total
# high-water. The gauges and `hbm_stats` sum over owners, so a process
# with one owner per component reads as JAX's (component, device) ledger;
# two servers on one card (an in-process fleet) each record under their
# own owner instead of overwriting each other. Components re-record
# freely (a rebuilt pool overwrites current; high-water is monotone).
# Single-device callers land on device "0", ownerless callers on "".

_hbm_lock = make_lock("probes.hbm", rlock=True)
_hbm_current: dict[tuple[str, str, str], int] = {}  # (component, device, owner)
_hbm_high_water: dict[str, int] = {}                # component (+ "total")
_hbm_dev_high_water: dict[str, int] = {}            # device total
# owners whose holder was garbage-collected, dropped at the next ledger call
_hbm_collected: collections.deque = collections.deque()

_GUARDED_BY = {
    "_hbm_current": "_hbm_lock",
    "_hbm_high_water": "_hbm_lock",
    "_hbm_dev_high_water": "_hbm_lock",
    "_retrieval_backends": "_hbm_lock",
}


@assumes_held("_hbm_lock")
def _hbm_publish(touched: set) -> None:
    """Update the high-waters and the gauges of the ``(component,
    device)`` pairs in ``touched`` from ``_hbm_current`` (under the lock)."""
    comp_sums: dict[str, int] = {}
    pair_sums: dict[tuple[str, str], int] = {}
    dev_sums: dict[str, int] = {}
    for (c, d, _), v in _hbm_current.items():
        comp_sums[c] = comp_sums.get(c, 0) + v
        pair_sums[(c, d)] = pair_sums.get((c, d), 0) + v
        dev_sums[d] = dev_sums.get(d, 0) + v
    for c, _ in touched:
        if comp_sums.get(c, 0) > _hbm_high_water.get(c, -1):
            _hbm_high_water[c] = comp_sums.get(c, 0)
    total = sum(comp_sums.values())
    if total > _hbm_high_water.get("total", -1):
        _hbm_high_water["total"] = total
    for _, d in touched:
        if dev_sums.get(d, 0) > _hbm_dev_high_water.get(d, -1):
            _hbm_dev_high_water[d] = dev_sums.get(d, 0)
    high = dict(_hbm_high_water)
    dev_high = dict(_hbm_dev_high_water)
    for c, d in sorted(touched):
        REGISTRY.gauge_set("hbm_bytes", pair_sums.get((c, d), 0), component=c, device=d)
        REGISTRY.gauge_set("hbm_bytes", comp_sums.get(c, 0), component=c)
    for comp, hw in high.items():
        REGISTRY.gauge_max("hbm_high_water_bytes", hw, component=comp)
    for d, hw in dev_high.items():
        REGISTRY.gauge_max("hbm_high_water_bytes", hw, component="total", device=d)


def drop_hbm_owner_at_collect(holder, owner: str) -> None:
    """Drop ``owner``'s entries once ``holder`` is garbage-collected (a
    model or pipeline let go without ``close()``). The drop waits for the
    next ledger call, which makes it before anything else: a collection
    may run inside one, and a new holder may reuse the owner's id."""
    weakref.finalize(holder, _hbm_collected.append, str(owner))


@assumes_held("_hbm_lock")
def _drop_collected() -> None:
    """Apply the drops :func:`drop_hbm_owner_at_collect` queued (under the
    lock)."""
    touched = set()
    while _hbm_collected:
        owner = _hbm_collected.popleft()
        for key in [k for k in _hbm_current if k[2] == owner]:
            del _hbm_current[key]
            touched.add(key[:2])
    if touched and REGISTRY.enabled:
        _hbm_publish(touched)


def record_hbm(component: str, nbytes: int, device: str = "0", owner: str = "") -> None:
    """Record ``component``'s current device footprint (bytes) on
    ``device`` (the CUDA index as a string, "0" on the CPU, the mesh position
    for sharded weights and pools) for ``owner``
    (a server's or pipeline's tag; "" for the process). Called at weight
    placement and pool build, never on the per-token path."""
    if not REGISTRY.enabled:
        return
    dev = str(device)
    with _hbm_lock:
        _drop_collected()
        _hbm_current[(component, dev, str(owner))] = int(nbytes)
        _hbm_publish({(component, dev)})


def drop_hbm_owner(owner: str) -> None:
    """Forget every entry ``owner`` recorded (a server shut down, a
    pipeline let go): its components' gauges fall by its bytes; the
    high-waters stay. Nothing in JAX drops entries (a replica's bytes
    outlive it there)."""
    with _hbm_lock:
        _drop_collected()
        gone = [key for key in _hbm_current if key[2] == str(owner)]
        for key in gone:
            del _hbm_current[key]
        # like the resets, the drop applies with metrics off; only the
        # gauges wait for metrics on
        if gone and REGISTRY.enabled:
            _hbm_publish({(c, d) for c, d, _ in gone})


def hbm_owner_bytes(owner: str) -> dict[str, int]:
    """Current bytes ``owner`` holds per component (summed over devices);
    empty once the owner was dropped."""
    out: dict[str, int] = {}
    with _hbm_lock:
        _drop_collected()
        for (c, _, o), v in _hbm_current.items():
            if o == str(owner):
                out[c] = out.get(c, 0) + v
    return {c: out[c] for c in sorted(out)}


def hbm_stats() -> dict:
    """Current bytes per component (summed over devices and owners),
    per-component high-water, the totals, and the per-device breakdown."""
    with _hbm_lock:
        _drop_collected()
        current = dict(_hbm_current)
        high = dict(_hbm_high_water)
        dev_high = dict(_hbm_dev_high_water)
    comp_cur: dict[str, int] = {}
    dev_cur: dict[str, int] = {}
    dev_comp: dict[str, dict[str, int]] = {}
    for (c, d, _), v in current.items():
        comp_cur[c] = comp_cur.get(c, 0) + v
        dev_cur[d] = dev_cur.get(d, 0) + v
        dev_comp.setdefault(d, {})[c] = dev_comp.get(d, {}).get(c, 0) + v
    total_high = high.pop("total", sum(comp_cur.values()))
    return {
        "current_bytes": {k: comp_cur[k] for k in sorted(comp_cur)},
        "high_water_bytes": {k: high[k] for k in sorted(high)},
        "current_total_bytes": sum(comp_cur.values()),
        "high_water_total_bytes": total_high,
        "per_device_bytes": {k: dev_cur[k] for k in sorted(dev_cur)},
        "per_device_high_water_bytes": {k: dev_high[k] for k in sorted(dev_high)},
        "device_bytes": {d: {c: dev_comp[d][c] for c in sorted(dev_comp[d])}
                         for d in sorted(dev_comp)},
    }


def reset_hbm_stats() -> None:
    with _hbm_lock:
        _hbm_collected.clear()
        _hbm_current.clear()
        _hbm_high_water.clear()
        _hbm_dev_high_water.clear()
    REGISTRY.remove("hbm_bytes", "hbm_high_water_bytes")


def record_kv_fragmentation(value: float, server: str = "decoder") -> None:
    """Set the ``kv_fragmentation{server=}`` gauge: 1 - reachable /
    allocated KV bytes over the admitted slots (0.0 when idle). Updated by
    the continuous server at every admission and release."""
    REGISTRY.gauge_set("kv_fragmentation", value, server=server)


def kv_fragmentation_value(server: str = "decoder"):
    """Current ``kv_fragmentation`` gauge of ``server`` (None before the
    first admission)."""
    return REGISTRY.labelled("kv_fragmentation", "server", kind="gauge").get(server)


def record_kv_parked(nbytes: float, server: str = "decoder") -> None:
    """Set the ``kv_parked_bytes{server=}`` gauge: device KV bytes held by
    preempted requests' parked block rows. They are held on purpose (the
    re-admission reuses their prompt KV by a table edit), so they count
    apart from ``kv_fragmentation``."""
    REGISTRY.gauge_set("kv_parked_bytes", nbytes, server=server)


def kv_parked_value(server: str = "decoder"):
    """Current ``kv_parked_bytes`` gauge of ``server`` (None before the
    first preemption)."""
    return REGISTRY.labelled("kv_parked_bytes", "server", kind="gauge").get(server)


# --------------------------------------------------------------------- #
# device-dispatch counters

_current_op = threading.local()  # set by Scheduler._step_node


def record_device_dispatch(kind: str, n: int = 1) -> None:
    """Count ``n`` device round trips of ``kind`` (``embed_dispatch``,
    ``knn_append``, ``fused_retrieve``, ...). Thread-safe. When a
    scheduler step is on the stack the count is also attributed to the
    stepping operator (scheduler accounting: ``set_metrics`` does not gate
    it)."""
    REGISTRY.counter_add("device_dispatch", n, kind=kind)
    op = getattr(_current_op, "stats", None)
    if op is not None:
        op.dispatches += n


def dispatch_counts() -> dict[str, int]:
    return {k: int(v) for k, v in REGISTRY.labelled("device_dispatch", "kind").items()}


def reset_dispatch_counts() -> None:
    REGISTRY.remove("device_dispatch")


# --------------------------------------------------------------------- #
# retrieval-backend ledger: which index answered retrieval queries

_retrieval_backends: dict[str, int] = {}  # backend -> queries served


def record_retrieval_backend(backend: str, n: int = 1) -> None:
    """Count ``n`` retrieval queries answered by ``backend`` (``dense``
    for the port's brute-force index). Thread-safe."""
    REGISTRY.counter_add("retrieval_queries", n, backend=backend)
    with _hbm_lock:
        _retrieval_backends[backend] = _retrieval_backends.get(backend, 0) + n


def retrieval_backend_stats() -> dict[str, int]:
    """``{backend: queries}`` since the last reset (kept on the host even
    when metrics are off, as in JAX)."""
    with _hbm_lock:
        return dict(_retrieval_backends)


def reset_retrieval_backend_stats() -> None:
    with _hbm_lock:
        _retrieval_backends.clear()
    REGISTRY.remove("retrieval_queries")


# --------------------------------------------------------------------- #
# cascade-rerank ledger (fed by ``ops/fused_query.py``'s rerank cascade)

def record_cascade(stage: str, pairs: int, flops: float = 0.0) -> None:
    """Account ``pairs`` scored (and model ``flops`` paid) by cascade
    ``stage`` (``cheap`` / ``maxsim`` / ``full``). Thread-safe."""
    REGISTRY.counter_add("cascade_pairs", pairs, stage=stage)
    if flops:
        REGISTRY.counter_add("cascade_flops", flops, stage=stage)


def cascade_stats() -> dict:
    """Per-stage pairs and GFLOPs, and the survivor rate (full-pass pairs
    over first-stage pairs; 1.0 when the cascade never ran)."""
    pairs = {k: int(v) for k, v in REGISTRY.labelled("cascade_pairs", "stage").items()}
    flops = REGISTRY.labelled("cascade_flops", "stage")
    cheap = pairs.get("cheap", 0) + pairs.get("maxsim", 0)
    full = pairs.get("full", 0)
    rate = (full / cheap) if cheap else 1.0
    return {
        "pairs": pairs,
        "gflops": {k: round(v / 1e9, 3) for k, v in flops.items()},
        "survivor_rate": round(rate, 4),
    }


def reset_cascade_stats() -> None:
    REGISTRY.remove("cascade_pairs", "cascade_flops")


# --------------------------------------------------------------------- #
# attention-traffic ledger: an accounting model, not a hardware counter
# (``models/flash_attention.attn_bytes_dense`` / ``attn_bytes_flash``)

def record_attn(path: str, nbytes: float, saved: float = 0.0) -> None:
    """Account ``nbytes`` of modeled attention traffic on ``path``
    (``prefill`` = whole-prompt admissions, ``chunk`` = prefill pieces,
    ``encoder`` = embedder / cross-encoder stacks); ``saved`` is the
    dense-vs-flash delta when the flash arm ran. Thread-safe."""
    REGISTRY.counter_add("attn_bytes", nbytes, path=path)
    if saved:
        REGISTRY.counter_add("attn_bytes_saved", saved, path=path)


def attn_stats() -> dict:
    """Per-path modeled attention bytes, bytes saved against the dense
    accounting, and their totals."""
    bytes_ = {k: int(v) for k, v in REGISTRY.labelled("attn_bytes", "path").items()}
    saved = {k: int(v) for k, v in REGISTRY.labelled("attn_bytes_saved", "path").items()}
    return {
        "bytes": bytes_,
        "bytes_saved": saved,
        "total_bytes": sum(bytes_.values()),
        "total_saved": sum(saved.values()),
    }


def reset_attn_stats() -> None:
    REGISTRY.remove("attn_bytes", "attn_bytes_saved")


# --------------------------------------------------------------------- #
# prefix-KV-cache ledger

def record_prefix(kind: str, n: float = 1) -> None:
    """Account ``n`` of ``kind`` (``hit_tokens`` / ``miss_tokens`` /
    ``requests`` / ``hit_requests`` / ``inserted_blocks`` /
    ``evicted_blocks`` / ``copy_bytes`` / ``cached_bytes`` / the tier-2
    kinds). ``cached_bytes`` is a running delta, negative on eviction, kept
    as a gauge. ``copy_bytes`` counts device bytes duplicated to serve a
    hit (the dense pool's arena-to-slot copies; paged hits share blocks and
    leave it at zero). Thread-safe."""
    if kind == "cached_bytes":
        REGISTRY.gauge_add("prefix_cached_bytes", n)
    else:
        REGISTRY.counter_add("prefix_events", n, kind=kind)


def prefix_stats() -> dict:
    """Snapshot: raw counters plus the token-level ``hit_rate`` (hit tokens
    over hit + miss tokens; 0.0 before any prompt), ``prefill_tokens_saved``
    (the hit tokens) and the tier-2 lookups, hits and ``hit_rate_t2``."""
    c = REGISTRY.labelled("prefix_events", "kind")
    cached = REGISTRY.gauge_value("prefix_cached_bytes")
    if cached is not None:
        c["cached_bytes"] = cached
    hit = c.get("hit_tokens", 0)
    miss = c.get("miss_tokens", 0)
    total = hit + miss
    t2_l = c.get("t2_lookups", 0)
    t2_h = c.get("t2_hits", 0)
    return {
        "counts": {k: (int(v) if float(v).is_integer() else v)
                   for k, v in c.items()},
        "hit_rate": round(hit / total, 4) if total else 0.0,
        "prefill_tokens_saved": int(hit),
        "evicted_blocks": int(c.get("evicted_blocks", 0)),
        "cached_bytes": int(c.get("cached_bytes", 0)),
        "copy_bytes": int(c.get("copy_bytes", 0)),
        "hit_rate_t2": round(t2_h / t2_l, 4) if t2_l else 0.0,
        "t2_lookups": int(t2_l),
        "t2_hits": int(t2_h),
        "t2_hit_blocks": int(c.get("t2_hit_blocks", 0)),
        "t2_demoted_blocks": int(c.get("t2_demoted_blocks", 0)),
        "t2_promoted_blocks": int(c.get("t2_promoted_blocks", 0)),
    }


def reset_prefix_stats() -> None:
    REGISTRY.remove("prefix_events", "prefix_cached_bytes")


# --------------------------------------------------------------------- #
# speculative-decode ledger

def record_spec(kind: str, n: float = 1) -> None:
    """Account ``n`` of ``kind`` (``drafted`` / ``accepted`` / ``emitted``
    / ``verify_steps`` / ``draft_steps`` / ``dispatches`` /
    ``kv_bytes_saved``). ``verify_steps`` counts full-model lane-cycles
    (the unit one plain decode lane-step also costs), ``emitted`` every
    token produced (accepted drafts plus one certain token a lane-cycle).
    Thread-safe."""
    REGISTRY.counter_add("spec_events", n, kind=kind)


def record_spec_many(**counts: float) -> None:
    """:func:`record_spec` for several kinds under one lock acquisition
    (the serving loop flushes a drain's six counters at once)."""
    REGISTRY.counter_add_many("spec_events", "kind", counts)


def spec_stats() -> dict:
    """Snapshot: raw counters plus ``acceptance_rate`` (accepted / drafted;
    0.0 before any draft ran), ``tokens_per_dispatch`` (emitted /
    verify_steps; 1.0 is the plain-decode baseline, 0.0 before any verify)
    and ``kv_bytes_saved``."""
    c = REGISTRY.labelled("spec_events", "kind")
    drafted = c.get("drafted", 0)
    verify = c.get("verify_steps", 0)
    return {
        "counts": {k: int(v) for k, v in c.items()},
        "acceptance_rate": round(c.get("accepted", 0) / drafted, 4) if drafted else 0.0,
        "tokens_per_dispatch": round(c.get("emitted", 0) / verify, 4) if verify else 0.0,
        "kv_bytes_saved": int(c.get("kv_bytes_saved", 0)),
    }


def reset_spec_stats() -> None:
    REGISTRY.remove("spec_events")


# --------------------------------------------------------------------- #
# pipeline-stage ledger (bubble attribution)

def record_stage(stage: str, seconds: float, items: int = 1) -> None:
    """Accumulate ``seconds`` of host time and ``items`` for pipeline
    ``stage``. Thread-safe: stage workers call it, so overlapped stages
    can sum to more than wall time."""
    REGISTRY.counter_add("stage_seconds", seconds, stage=stage)
    REGISTRY.counter_add("stage_items", items, stage=stage)


def stage_seconds() -> dict[str, float]:
    return REGISTRY.labelled("stage_seconds", "stage")


def stage_items() -> dict[str, float]:
    return REGISTRY.labelled("stage_items", "stage")


def reset_stage_seconds() -> None:
    REGISTRY.remove("stage_seconds", "stage_items")


def bubble_attribution(wall_s: float, stages: dict[str, float] | None = None) -> dict:
    """Split a window's wall time across pipeline stages (the global
    ledger by default): host stages as measured, ``compute`` the residual
    ``wall - sum(host stages)`` clipped at zero. ``sum_host_pct`` above 100
    means stage workers overlapped."""
    stages = dict(stages if stages is not None else stage_seconds())
    wall = max(wall_s, 1e-12)
    host_total = sum(stages.values())
    compute = max(0.0, wall_s - host_total)
    out: dict = {
        "wall_s": round(wall_s, 6),
        "stages_s": {k: round(v, 6) for k, v in sorted(stages.items())},
        "compute_residual_s": round(compute, 6),
        "pct": {k: round(100.0 * v / wall, 2) for k, v in sorted(stages.items())},
        "sum_host_pct": round(100.0 * host_total / wall, 2),
    }
    out["pct"]["compute"] = round(100.0 * compute / wall, 2)
    return out


# --------------------------------------------------------------------- #
# roofline model, against the card's published peaks

def roofline_ceiling(
    flops: float,
    bytes_moved: float,
    *,
    wall_s: float | None = None,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
    peak_bytes: float = H100_PEAK_HBM_BYTES,
) -> dict:
    """The roofline bound of a workload: ``max(flops / peak_flops, bytes /
    peak_bytes)`` is the least device time; ``ceiling_mfu_pct`` the best
    MFU it can post. With the observed ``wall_s``, also how much of the
    wall is the bound and how much overhead above it."""
    t_compute = flops / peak_flops
    t_memory = bytes_moved / peak_bytes
    t_lb = max(t_compute, t_memory, 1e-12)
    out: dict = {
        "flops_time_s": round(t_compute, 6),
        "memory_time_s": round(t_memory, 6),
        "bound_time_s": round(t_lb, 6),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arith_intensity": round(flops / max(bytes_moved, 1.0), 2),
        "ridge_intensity": round(peak_flops / peak_bytes, 2),
        "ceiling_mfu_pct": round(100.0 * t_compute / t_lb, 2),
        "ceiling_hbm_pct": round(100.0 * t_memory / t_lb, 2),
    }
    if wall_s is not None:
        wall = max(wall_s, 1e-12)
        out["wall_s"] = round(wall_s, 6)
        out["attained_of_ceiling_pct"] = round(100.0 * t_lb / wall, 2)
        out["overhead_above_bound_s"] = round(max(0.0, wall_s - t_lb), 6)
    return out


@dataclasses.dataclass
class PhaseRoofline:
    """Accumulated work of one pipeline phase (e.g. ``ingest``, ``query``)."""

    name: str
    seconds: float = 0.0
    flops: float = 0.0
    bytes_moved: float = 0.0
    dispatches: int = 0

    def summary(self, peak_flops: float = H100_PEAK_BF16_FLOPS,
                peak_bytes: float = H100_PEAK_HBM_BYTES) -> dict:
        s = max(self.seconds, 1e-12)
        mfu = self.flops / (s * peak_flops)
        bw_util = self.bytes_moved / (s * peak_bytes)
        # arithmetic intensity against the ridge point decides the ceiling;
        # far from both is overhead
        ai = self.flops / max(self.bytes_moved, 1.0)
        bound = "compute" if ai >= peak_flops / peak_bytes else "memory"
        if max(mfu, bw_util) < 0.05:
            bound = "overhead"
        return {
            "phase": self.name,
            "seconds": round(self.seconds, 6),
            "gflops": round(self.flops / 1e9, 3),
            "gbytes": round(self.bytes_moved / 1e9, 3),
            "dispatches": self.dispatches,
            "mfu_pct": round(100.0 * mfu, 2),
            "hbm_util_pct": round(100.0 * bw_util, 2),
            "arith_intensity": round(ai, 2),
            "bound": bound,
        }


@guarded_by(phases="_lock")
class RooflineModel:
    """Per-phase (seconds, FLOPs, bytes) ledger -> MFU / bandwidth report."""

    def __init__(self, peak_flops: float = H100_PEAK_BF16_FLOPS,
                 peak_bytes: float = H100_PEAK_HBM_BYTES):
        self.peak_flops = peak_flops
        self.peak_bytes = peak_bytes
        self._lock = make_lock("probes.roofline", rlock=True)
        self.phases: dict[str, PhaseRoofline] = {}

    def add(self, phase: str, *, seconds: float = 0.0, flops: float = 0.0,
            bytes_moved: float = 0.0, dispatches: int = 0) -> None:
        with self._lock:
            p = self.phases.get(phase)
            if p is None:
                p = self.phases[phase] = PhaseRoofline(name=phase)
            p.seconds += seconds
            p.flops += flops
            p.bytes_moved += bytes_moved
            p.dispatches += dispatches

    def summary(self) -> dict:
        with self._lock:
            return {name: p.summary(self.peak_flops, self.peak_bytes)
                    for name, p in self.phases.items()}


@dataclasses.dataclass
class OperatorStats:
    name: str
    rows_in: int = 0
    rows_out: int = 0
    epochs: int = 0
    total_time_s: float = 0.0
    last_active_time: float = 0.0
    dispatches: int = 0

    @property
    def lag_s(self) -> float:
        return max(0.0, time.time() - self.last_active_time)


@dataclasses.dataclass
class ConnectorStats:
    name: str
    rows_read: int = 0
    commits: int = 0
    finished: bool = False


@guarded_by(operators="_lock", connectors="_lock", steps_skipped="_lock")
class SchedulerStats:
    """Thread-safe stats registry attached to a live scheduler.

    Only the collections (and the skip counter) are guarded:
    ``current_time`` / ``epochs_total`` / ``finished`` / ``fused_*`` are
    written by the single scheduler thread before workers start or after
    they stop."""

    def __init__(self) -> None:
        self._lock = make_lock("probes.scheduler_stats")
        self.operators: dict[int, OperatorStats] = {}
        # keyed by connector node id (names may collide across connectors)
        self.connectors: dict[int, ConnectorStats] = {}
        self.current_time: int = -1
        self.epochs_total: int = 0
        self.started_at: float = time.time()
        self.finished: bool = False
        # chain-fusion plan summary (set by the scheduler after fuse_chains)
        self.fused_chains: int = 0
        self.fused_nodes: int = 0
        # epochs where a node's step was skipped (no input deltas, no
        # injection) — the sparse-stepping win made countable
        self.steps_skipped: int = 0
        # several processes: exchanged rows by direction (local / sent /
        # received / broadcast), and at teardown the mesh's bytes_sent /
        # bytes_received / control_rounds
        self.exchange: dict[str, int] = {}

    def operator(self, node_id: int, name: str) -> OperatorStats:
        with self._lock:
            stats = self.operators.get(node_id)
            if stats is None:
                stats = self.operators[node_id] = OperatorStats(name=name)
            return stats

    def connector(self, node_id: int, name: str) -> ConnectorStats:
        with self._lock:
            stats = self.connectors.get(node_id)
            if stats is None:
                stats = self.connectors[node_id] = ConnectorStats(name=name)
            return stats

    def record_connector_commit(self, node_id: int, name: str, n_rows: int) -> None:
        stats = self.connector(node_id, name)
        with self._lock:
            stats.rows_read += n_rows
            stats.commits += 1

    def connector_finished(self, node_id: int, name: str) -> None:
        self.connector(node_id, name).finished = True

    def record_exchange(self, **rows: int) -> None:
        with self._lock:
            for k, v in rows.items():
                self.exchange[k] = self.exchange.get(k, 0) + v

    def record_skip(self) -> None:
        with self._lock:
            self.steps_skipped += 1

    def record_step(
        self, node_id: int, name: str, rows_in: int, rows_out: int, dt: float
    ) -> None:
        stats = self.operator(node_id, name)
        with self._lock:
            stats.rows_in += rows_in
            stats.rows_out += rows_out
            stats.epochs += 1
            stats.total_time_s += dt
            stats.last_active_time = time.time()

    def snapshot(self) -> dict:
        """Plain-dict snapshot for renderers/exporters."""
        with self._lock:
            return {
                "current_time": self.current_time,
                "epochs_total": self.epochs_total,
                "uptime_s": time.time() - self.started_at,
                "finished": self.finished,
                "fused_chains": self.fused_chains,
                "fused_nodes": self.fused_nodes,
                "steps_skipped": self.steps_skipped,
                "operators": [dataclasses.asdict(s) for s in self.operators.values()],
                "connectors": [dataclasses.asdict(s) for s in self.connectors.values()],
            }

    def engine_tax(self) -> dict:
        """Aggregate engine-overhead view: total operator wall seconds split
        into dispatch-bearing vs pure-Python steps. ``wall_s`` is the sum of
        per-operator step time; with the device-dispatch counters this
        separates 'the chip was working' from 'the engine was shuffling'."""
        with self._lock:
            wall = sum(s.total_time_s for s in self.operators.values())
            steps = sum(s.epochs for s in self.operators.values())
            dispatches = sum(s.dispatches for s in self.operators.values())
            return {
                "wall_s": round(wall, 6),
                "steps": steps,
                "steps_skipped": self.steps_skipped,
                "operator_dispatches": dispatches,
                "fused_chains": self.fused_chains,
                "fused_nodes": self.fused_nodes,
            }
