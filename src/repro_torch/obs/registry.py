"""Zero-dependency metrics registry: counters, gauges, log-bucket histograms.

Every plane of the system (training rounds, sparse ingest, serving) reports
through one process-global :class:`Registry` so a single ``snapshot()``
answers "what did this process do and what did it cost" — and every
``benchmarks/*.py --json`` embeds exactly that snapshot under a
``"metrics"`` key (``benchmarks/run.py`` owns the shared schema).

Design constraints, in order:

* **zero dependencies** — stdlib only, importable from anywhere (kernels,
  benches, CI helpers) without dragging torch/numpy in;
* **cheap when disabled** — ``set_enabled(False)`` swaps every instrument
  for a shared no-op object, so instrumented hot paths cost one attribute
  call (the telemetry-overhead CI gate pins the enabled path within 2%
  of off on the gossip bench);
* **percentiles without samples** — :class:`Histogram` buckets are *fixed
  log-spaced edges*, so p50/p99 are derivable from the snapshot alone
  (no reservoir, no unbounded memory), with relative error bounded by the
  bucket ratio (10^(1/10) ≈ 26% worst-case, ~12% expected).

Metric identity is ``(name, sorted labels)``, Prometheus-style::

    from repro_torch import obs
    obs.counter("ingest_appends_total").inc()
    obs.histogram("serve_batch_seconds").observe(0.0031)
    obs.gauge("ingest_routed_entries", shard="0,1").set(1234)
    obs.snapshot()["histograms"]["serve_batch_seconds"]["p99"]

This is the port's copy of ``repro.obs.registry``: the port keeps its own
registry so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, Optional, Tuple

# 10 buckets per decade from 1 µs to 10 ks: wide enough for any latency or
# byte-count this repo measures, narrow enough that p50/p99 interpolation
# stays within ~12% of the numpy oracle (tests/test_obs.py pins it).
_BUCKETS_PER_DECADE = 10
DEFAULT_EDGES: Tuple[float, ...] = tuple(
    10.0 ** (k / _BUCKETS_PER_DECADE) for k in
    range(-6 * _BUCKETS_PER_DECADE, 4 * _BUCKETS_PER_DECADE + 1)
)


def _key(name: str, labels: Dict[str, str]) -> str:
    """Canonical metric id: ``name`` or ``name{k=v,...}`` (sorted keys)."""

    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic count (events, entries, bytes)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (free slots, staleness, queue depth)."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed log-spaced-bucket histogram with derivable percentiles.

    ``edges`` are the *upper* bounds of each bucket; observations above the
    last edge land in a final overflow bucket.  ``quantile(q)`` walks the
    cumulative counts to the target rank and interpolates linearly inside
    the winning bucket — accurate to the bucket width by construction, so
    p50/p99 come straight out of a snapshot with no raw samples retained.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, edges: Optional[Iterable[float]] = None) -> None:
        self.edges = tuple(edges) if edges is not None else DEFAULT_EDGES
        if len(self.edges) < 2 or any(
            a >= b for a, b in zip(self.edges, self.edges[1:])
        ):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        """Index of the first edge ≥ v (bisect; stdlib-only)."""

        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.edges[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[self._bucket(v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], interpolated inside the
        winning bucket; ``nan`` while empty.  Clamped to the observed
        [min, max] so a lone sample reports itself, not its bucket edge."""

        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.max
                frac = (rank - seen) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self) -> Dict[str, float]:
        """The snapshot form: moments + the standard percentiles."""

        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class _Noop:
    """Shared do-nothing instrument handed out while telemetry is off.

    Quacks like all three metric types; every reading is the neutral
    element so disabled-mode callers can still do arithmetic on it."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, n: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return math.nan

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0}


NOOP = _Noop()


class Registry:
    """Get-or-create metric store; the process-global default lives in
    this module (``repro_torch.obs.registry`` / the ``repro_torch.obs``
    facade)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- instruments --------------------------------------------------- #

    def counter(self, name: str, /, **labels: str) -> Counter:
        if not self.enabled:
            return NOOP  # type: ignore[return-value]
        k = _key(name, labels)
        with self._lock:
            if k not in self._counters:
                self._counters[k] = Counter()
            return self._counters[k]

    def gauge(self, name: str, /, **labels: str) -> Gauge:
        if not self.enabled:
            return NOOP  # type: ignore[return-value]
        k = _key(name, labels)
        with self._lock:
            if k not in self._gauges:
                self._gauges[k] = Gauge()
            return self._gauges[k]

    def histogram(self, name: str, edges: Optional[Iterable[float]] = None,
                  /, **labels: str) -> Histogram:
        if not self.enabled:
            return NOOP  # type: ignore[return-value]
        k = _key(name, labels)
        with self._lock:
            if k not in self._histograms:
                self._histograms[k] = Histogram(edges)
            return self._histograms[k]

    # -- export -------------------------------------------------------- #

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view of every metric — the one export schema
        (``benchmarks/run.py`` embeds it, ``scripts/obs_report.py``
        renders it)."""

        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def reset(self) -> None:
        """Drop every metric (benches reset between phases; tests)."""

        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# --------------------------------------------------------------------- #
# the process-global default registry + module-level conveniences
# --------------------------------------------------------------------- #

_default = Registry()


def get_registry() -> Registry:
    return _default


def set_enabled(on: bool) -> bool:
    """Flip the default registry's enabled flag; returns the previous
    value (so callers can restore): the telemetry on/off switch every
    instrumented plane respects."""

    prev = _default.enabled
    _default.enabled = bool(on)
    return prev


def enabled() -> bool:
    return _default.enabled


def counter(name: str, /, **labels: str) -> Counter:
    return _default.counter(name, **labels)


def gauge(name: str, /, **labels: str) -> Gauge:
    return _default.gauge(name, **labels)


def histogram(name: str, edges: Optional[Iterable[float]] = None,
              /, **labels: str) -> Histogram:
    return _default.histogram(name, edges, **labels)


def snapshot() -> Dict[str, Dict]:
    return _default.snapshot()


def to_json(indent: Optional[int] = None) -> str:
    return _default.to_json(indent)


def reset() -> None:
    _default.reset()
