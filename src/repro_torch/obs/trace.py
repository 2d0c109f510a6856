"""Host-clock spans, off unless enabled (a minimal copy of
``repro/obs/trace.py``).

``span()`` checks one module flag and returns a shared no-op when tracing is
off: no allocation beyond the call, no clock read.  When on (``enable()`` or
``REPRO_TRACE=1``), finished spans land in a bounded ring buffer.  Spans wrap
host-side phases; they do not synchronize the device, so around CUDA work
they time the enqueue unless the caller synchronizes.  ``enable(
device_events=True)`` also records a CUDA event on the current stream as
each span starts and ends (``Span.events``); after a synchronize,
``device_ms(span)`` is the card's time between the two.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_TRUTHY = ("1", "true", "yes", "on")
DEFAULT_CAPACITY = 1 << 16


@dataclass(frozen=True)
class Span:
    name: str
    ts_us: float
    dur_us: float
    tags: Dict[str, object] = field(default_factory=dict)
    events: Tuple = ()       # (start, end) CUDA events with device events on


class Tracer:
    """Thread-safe bounded buffer of finished spans."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(capacity))
        self.n_recorded = 0
        self.epoch_ns = time.perf_counter_ns()

    def record(self, sp: Span) -> None:
        with self._lock:
            self._buf.append(sp)
            self.n_recorded += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self.n_recorded = 0
            self.epoch_ns = time.perf_counter_ns()


_tracer = Tracer()
_enabled = os.environ.get("REPRO_TRACE", "").lower() in _TRUTHY
_device_events = False


def get_tracer() -> Tracer:
    return _tracer


def enabled() -> bool:
    return _enabled


def enable(device_events: bool = False) -> None:
    """Record spans; ``device_events`` adds a CUDA event at each end (needs
    a card)."""
    global _enabled, _device_events
    _enabled, _device_events = True, bool(device_events)


def disable() -> None:
    global _enabled, _device_events
    _enabled, _device_events = False, False


def _cuda_event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def device_ms(sp: Span) -> float:
    """The card's milliseconds between a span's two events (the caller has
    synchronized)."""
    return sp.events[0].elapsed_time(sp.events[1])


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kv):
        return self


NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("name", "tags", "_t0_ns", "_ev0")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.tags = tags
        self._t0_ns = 0
        self._ev0 = None

    def tag(self, **kv) -> "_SpanCtx":
        self.tags.update(kv)
        return self

    def __enter__(self):
        if _device_events:
            self._ev0 = _cuda_event()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.perf_counter_ns()
        events = (self._ev0, _cuda_event()) if self._ev0 is not None else ()
        _tracer.record(Span(self.name, (self._t0_ns - _tracer.epoch_ns) / 1e3,
                            (t1_ns - self._t0_ns) / 1e3, self.tags, events))
        return False


def span(name: str, **tags):
    """``with span("serve/prefill", tokens=16) as sp: ...``; a shared no-op
    when tracing is off."""
    if not _enabled:
        return NULL_SPAN
    return _SpanCtx(name, tags)
