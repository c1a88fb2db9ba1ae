"""OpenTelemetry integration (counterpart of
``pathway_tpu/internals/telemetry.py``; reference
``graph_runner/telemetry.py``).

Spans wrap a run (``pw.run``'s ``pathway-tpu.run``) and the serving
request spans of ``engine/tracing.py`` when the ``opentelemetry`` packages
are importable AND a collector endpoint is configured
(``pw.set_monitoring_config(server_endpoint=...)``; the port does not read
``PATHWAY_MONITORING_SERVER``); otherwise every call is a cheap no-op, so
the runtime has no hard dependency. The span names, the service name and
the ``pathway_tpu.*`` attribute keys are JAX's, so one collector sees the
two packages alike.
"""

from __future__ import annotations

import importlib.util
import sys
from contextlib import contextmanager
from typing import Any


def _otel_available() -> bool:
    try:
        return importlib.util.find_spec("opentelemetry") is not None
    except ValueError:  # a module without a spec (set up by hand): look it up
        return "opentelemetry" in sys.modules


class Telemetry:
    """Per-run telemetry handle (reference ``Telemetry`` in
    ``graph_runner/telemetry.py:140``)."""

    def __init__(self, endpoint: str | None):
        self.endpoint = endpoint
        self._tracer = None
        self._provider = None
        if endpoint and _otel_available():
            try:
                from opentelemetry import trace
                from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                    OTLPSpanExporter,
                )
                from opentelemetry.sdk.resources import Resource
                from opentelemetry.sdk.trace import TracerProvider
                from opentelemetry.sdk.trace.export import BatchSpanProcessor

                provider = TracerProvider(
                    resource=Resource.create({"service.name": "pathway-tpu"})
                )
                provider.add_span_processor(
                    BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
                )
                self._tracer = trace.get_tracer("pathway-tpu", tracer_provider=provider)
                self._provider = provider
            except Exception:  # noqa: BLE001 — telemetry must never break a run
                self._tracer = None
                self._provider = None

    @classmethod
    def create(cls, run_id: str | None = None) -> "Telemetry":
        from pathway_tpu_torch.internals import config as config_mod

        return cls(config_mod.monitoring_server)

    @property
    def enabled(self) -> bool:
        return self._tracer is not None

    @contextmanager
    def span(self, name: str, attributes: dict[str, Any] | None = None):
        if self._tracer is None:
            yield None
            return
        with self._tracer.start_as_current_span(name) as s:
            for k, v in (attributes or {}).items():
                try:
                    s.set_attribute(k, v)
                except Exception:  # noqa: BLE001
                    pass
            yield s

    def shutdown(self) -> None:
        """Flush queued spans and stop the exporter — short runs would
        otherwise exit before BatchSpanProcessor's export interval."""
        if self._provider is not None:
            try:
                self._provider.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self._provider = None
            self._tracer = None

    def event(self, name: str, attributes: dict[str, Any] | None = None) -> None:
        if self._tracer is None:
            return
        try:
            from opentelemetry import trace

            span = trace.get_current_span()
            span.add_event(name, attributes or {})
        except Exception:  # noqa: BLE001
            pass


def get_imported_xpacks() -> list[str]:
    """Names of loaded xpacks, for run attribution (reference
    ``telemetry.py:XPACKS``)."""
    import sys

    prefix = "pathway_tpu_torch.xpacks."
    found = set()
    for mod in list(sys.modules):
        if mod.startswith(prefix):
            rest = mod[len(prefix):]
            if rest:
                found.add(rest.split(".")[0])
    return sorted(found)
