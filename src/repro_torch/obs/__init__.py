"""``repro_torch.obs`` — the port's metrics registry (counters, gauges,
histograms), a copy of ``repro.obs.registry``.  Spans wait for a later
slice; the sparse ingest path bumps its counters here."""

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

__all__ = [
    "DEFAULT_EDGES",
    "Counter",
    "Gauge",
    "Histogram",
    "NOOP",
    "Registry",
    "counter",
    "enabled",
    "gauge",
    "get_registry",
    "histogram",
    "reset",
    "set_enabled",
    "snapshot",
    "to_json",
]
