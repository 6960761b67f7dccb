"""Device-true timed regions + profiler trace capture.

Port of ``repro.obs.spans``.  ``time.perf_counter()`` around work queued
on the card measures the *enqueue*, not the compute: PyTorch returns
before the card finishes.  :func:`span` is the one primitive that gets it
right::

    from repro_torch import obs

    with obs.span("gossip.rounds") as sp:
        carry = step(problem, carry)
        sp.outputs(carry)              # declare what must be finished

    sp.seconds       # device-true: the clock stops after a synchronize
    sp.host_seconds  # enqueue-only wall, for async-depth diagnosis

Both times land in the default registry as histograms
(``span_seconds{name=...}`` and ``span_host_seconds{name=...}``).
``annotate=True`` also wraps the region in
``torch.profiler.record_function``, so it appears as a named slice in a
trace captured by :func:`trace`::

    with obs.trace("/tmp/trace"):             # writes /tmp/trace/trace.json
        with obs.span("fit", annotate=True) as sp:
            ...

``device_sync`` is the exported sync primitive (``BenchLogger`` and
``Telemetry`` use it, so their stamps and span timings agree).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional

import torch

from repro_torch.obs import registry as _reg

TRACE_FILE = "trace.json"


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def device_sync(tree: Any) -> Any:
    """Wait until the work producing every tensor in ``tree`` (nested
    tuples, lists, dicts, NamedTuples) is done: ``torch.cuda.synchronize``
    on each card the tensors live on, nothing for CPU tensors or other
    leaves.  Returns ``tree``."""

    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class Span:
    """One timed region; use via :func:`span`.

    ``outputs(x)`` declares the tensors whose completion defines the
    region's end — the exit path synchronizes on them *before* stopping
    the clock, so ``seconds`` is device-true.  Without declared outputs
    the span is host wall-clock (``host_seconds == seconds``)."""

    __slots__ = ("name", "registry", "annotate", "_outputs", "_t0",
                 "host_seconds", "seconds", "_annotation")

    def __init__(self, name: str, registry: Optional[_reg.Registry] = None,
                 annotate: bool = False):
        self.name = name
        self.registry = registry if registry is not None else _reg.get_registry()
        self.annotate = annotate
        self._outputs: Any = None
        self._annotation = None
        self.host_seconds: Optional[float] = None
        self.seconds: Optional[float] = None

    def outputs(self, tree: Any) -> Any:
        """Declare (accumulate) the tensors that end this span; returns the
        tree unchanged so call sites can wrap a producing expression."""

        if self._outputs is None:
            self._outputs = tree
        else:
            self._outputs = (self._outputs, tree)
        return tree

    def __enter__(self) -> "Span":
        if self.annotate:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.host_seconds = time.perf_counter() - self._t0
        if exc_type is None and self._outputs is not None:
            device_sync(self._outputs)
        self.seconds = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        if exc_type is None and self.registry.enabled:
            self.registry.histogram(
                "span_seconds", name=self.name).observe(self.seconds)
            self.registry.histogram(
                "span_host_seconds", name=self.name).observe(self.host_seconds)


def span(name: str, registry: Optional[_reg.Registry] = None,
         annotate: bool = False) -> Span:
    """Context manager: a named, registry-recorded, device-true timer."""

    return Span(name, registry=registry, annotate=annotate)


@contextlib.contextmanager
def trace(log_dir: str, device: str = "cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    https://ui.perfetto.dev).  Spans entered with ``annotate=True`` show
    up as named slices.

    On the card (``device="cuda"``, the default) the CUDA activity is
    recorded too, and the trace must hold device events: a region that
    recorded none raises ``RuntimeError`` instead of passing off a
    host-only profile.  ``device="cpu"`` records the host only."""

    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device=\"cpu\" "
                "to trace the host only")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    if on_card:
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    if on_card and not any(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError(
            "the profiler recorded no CUDA activity in the traced region; "
            f"the trace in {log_dir} holds host events only")
