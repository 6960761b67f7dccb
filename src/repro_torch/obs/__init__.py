"""``repro_torch.obs`` — the port's telemetry: one metrics registry
(counters, gauges, histograms; a copy of ``repro.obs.registry``), one
device-true span primitive and a profiler trace (``obs/spans.py``).

    from repro_torch import obs

    obs.counter("my_events_total").inc()
    with obs.span("hot.region") as sp:
        sp.outputs(fn(x))
    obs.snapshot()["histograms"]["span_seconds{name=hot.region}"]["p99"]
"""

from repro_torch.obs.registry import (
    DEFAULT_EDGES,
    NOOP,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    enabled,
    gauge,
    get_registry,
    histogram,
    reset,
    set_enabled,
    snapshot,
    to_json,
)
from repro_torch.obs.spans import Span, device_sync, span, trace

__all__ = [
    "DEFAULT_EDGES",
    "Counter",
    "Gauge",
    "Histogram",
    "NOOP",
    "Registry",
    "Span",
    "counter",
    "device_sync",
    "enabled",
    "gauge",
    "get_registry",
    "histogram",
    "reset",
    "set_enabled",
    "snapshot",
    "span",
    "to_json",
    "trace",
]
