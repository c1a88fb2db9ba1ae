"""OpenMetrics text of the port's metrics registry (counterpart of
``registry_text`` and ``openmetrics_text`` in
``pathway_tpu/internals/http_server.py``).

:func:`registry_text` renders ``engine/probes.REGISTRY`` (counters,
gauges and the serving latency histograms) as OpenMetrics families under
the ``pathway_tpu_`` prefix, the names the JAX package exposes;
:func:`openmetrics_text` is that text plus the ``# EOF`` terminator. The
port has no dataflow scheduler, so there are no scheduler gauges, and no
HTTP server: a caller serves the text itself.
"""

from __future__ import annotations

from pathway_tpu_torch.engine import probes

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
