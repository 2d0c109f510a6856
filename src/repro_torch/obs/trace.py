"""Round-trace flight recorder: spans, ring buffer, JSONL/Chrome exporters
(port of ``repro/obs/trace.py``, with ``torch.profiler`` in place of
``jax.profiler``).

Design constraints:

* **Near-zero cost when disabled.**  ``span()`` checks one module-level flag
  and returns a single shared no-op context manager: no object allocation,
  no clock read, no lock.  Tracing is off unless ``enable()`` is called or
  ``REPRO_TRACE=1`` is set in the environment.

* **No host sync.**  Spans wrap host-side phases; they never synchronize the
  device, so around CUDA work they time the enqueue unless the caller
  synchronizes.  ``enable(device_events=True)`` also records a CUDA event on
  the current stream as each span starts and ends (``Span.events``, never
  exported); after a synchronize, ``device_ms(span)`` is the card's time
  between the two.

* **Profiler passthrough.**  With ``enable(profiler_annotations=True)`` or
  ``REPRO_TRACE_PROFILER=1`` every span also opens a
  ``torch.profiler.record_function`` range of its name, so a
  ``torch.profiler`` trace shows the same phases; ``annotate(name)`` is such
  a range without a host span and ``step_annotation(step)`` marks a round.

* **Flight recorder.**  Spans land in a fixed-capacity thread-safe ring
  buffer: a long run keeps the most recent window instead of growing without
  bound, and ``n_evicted`` says how much history scrolled off.

* **Device tallies.**  ``tally(name, value)`` adds a count to the current
  trace: a number on the host, or a 0-d tensor summed on its device, so a
  count that only the device knows (a routing's held rows) costs no host
  sync per call.  Tallies reset with the ring buffer; ``Tracer.tallies()``
  reads them (one sync), and ``MetricsRegistry.ingest_tallies`` turns them
  into counters when a report or a benchmark asks.

Usage::

    from repro_torch.obs import trace

    trace.enable()
    with trace.span("sync/encode", level="inter") as sp:
        payload = encode(...)
        sp.tag(nbytes=payload.nbytes)

    @trace.traced("codec/roundtrip")
    def roundtrip(x): ...

    trace.export_jsonl("TRACE_round.jsonl")
    trace.export_chrome_trace("TRACE_round.json")   # chrome://tracing

A JSONL written here loads in ``repro.obs.trace.load_jsonl`` and the other
way round: the two packages share the format.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_TRUTHY = ("1", "true", "yes", "on")

DEFAULT_CAPACITY = 1 << 16  # spans kept before the flight recorder wraps


@dataclass(frozen=True)
class Span:
    """One completed span: [ts_us, ts_us + dur_us) on the tracer's epoch."""
    name: str
    ts_us: float          # start, microseconds since the tracer's epoch
    dur_us: float
    tid: int              # recording thread ident
    depth: int            # nesting depth within the thread (0 = top level)
    tags: Dict[str, object] = field(default_factory=dict)
    # (start, end) CUDA events with device events on; not exported
    events: Tuple = field(default=(), compare=False, repr=False)

    def to_json(self) -> dict:
        out = {"name": self.name, "ts_us": round(self.ts_us, 3),
               "dur_us": round(self.dur_us, 3), "tid": self.tid,
               "depth": self.depth}
        if self.tags:
            out["tags"] = self.tags
        return out

    @classmethod
    def from_json(cls, d: dict) -> "Span":
        return cls(d["name"], float(d["ts_us"]), float(d["dur_us"]),
                   int(d.get("tid", 0)), int(d.get("depth", 0)),
                   dict(d.get("tags", {})))

    def encloses(self, other: "Span") -> bool:
        """Interval containment on the same thread (parent candidate)."""
        return (self.tid == other.tid
                and self.ts_us <= other.ts_us
                and self.ts_us + self.dur_us >= other.ts_us + other.dur_us)


class Tracer:
    """Thread-safe fixed-capacity ring buffer of spans + run metadata."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._next = 0          # write cursor
        self._recorded = 0      # total spans ever recorded
        self.meta: Dict[str, object] = {}
        self.epoch_ns = time.perf_counter_ns()
        self._tallies: Dict[str, object] = {}

    # -- recording ----------------------------------------------------------
    def record(self, sp: Span) -> None:
        with self._lock:
            self._buf[self._next] = sp
            self._next = (self._next + 1) % self.capacity
            self._recorded += 1

    def reset(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._next = 0
            self._recorded = 0
            self.meta = {}
            self.epoch_ns = time.perf_counter_ns()
            self._tallies = {}

    def tally(self, name: str, value) -> None:
        """Add the count ``value`` (a number, or a 0-d integer tensor
        accumulated on its device: no host sync) to the tally ``name``."""
        with self._lock:
            cur = self._tallies.get(name)
            if cur is None:
                cur = value.detach().clone().long() if hasattr(value, "detach") else value
            elif hasattr(cur, "add_"):
                cur.add_(value)
            else:
                cur = cur + value
            self._tallies[name] = cur

    def tallies(self) -> Dict[str, float]:
        """Every tally since the last reset, read to the host."""
        with self._lock:
            items = list(self._tallies.items())
        return {k: float(v) for k, v in items}

    # -- introspection ------------------------------------------------------
    @property
    def n_recorded(self) -> int:
        return self._recorded

    @property
    def n_evicted(self) -> int:
        return max(0, self._recorded - self.capacity)

    def spans(self) -> List[Span]:
        """Retained spans in recording (completion) order, oldest first."""
        with self._lock:
            if self._recorded < self.capacity:
                return [s for s in self._buf[:self._next] if s is not None]
            return ([s for s in self._buf[self._next:] if s is not None]
                    + [s for s in self._buf[:self._next] if s is not None])

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self.epoch_ns) / 1e3


def wall_s() -> float:
    """Monotonic host wall clock in seconds: the training loop and the
    launchers time their phases through here, so measured wall clocks share
    a clock source with the trace epoch."""
    return time.perf_counter()


# ---------------------------------------------------------------------------
# module state: one default tracer + the flags everything checks
# ---------------------------------------------------------------------------
_tracer = Tracer()
_enabled = os.environ.get("REPRO_TRACE", "").lower() in _TRUTHY
_profiler_annotations = os.environ.get("REPRO_TRACE_PROFILER", "").lower() in _TRUTHY
_device_events = False
_tls = threading.local()


def get_tracer() -> Tracer:
    return _tracer


def enabled() -> bool:
    return _enabled


def enable(device_events: bool = False, profiler_annotations: Optional[bool] = None,
           capacity: Optional[int] = None) -> None:
    """Turn the flight recorder on, optionally resizing the ring buffer.
    ``device_events`` adds a CUDA event at each end of every span (needs a
    card); ``profiler_annotations`` opts into ``torch.profiler`` ranges
    alongside host spans (left as it was when None)."""
    global _enabled, _device_events, _profiler_annotations, _tracer
    if capacity is not None and capacity != _tracer.capacity:
        _tracer = Tracer(capacity)
    if profiler_annotations is not None:
        _profiler_annotations = bool(profiler_annotations)
    _enabled, _device_events = True, bool(device_events)


def disable() -> None:
    global _enabled, _device_events
    _enabled, _device_events = False, False


def tally(name: str, value) -> None:
    """Add ``value`` to the current trace's tally ``name``
    (``Tracer.tally``); a no-op while tracing is off."""
    if _enabled:
        _tracer.tally(name, value)


def set_meta(**kv) -> None:
    """Attach run-level metadata (sync config, n_params, ...) to the trace;
    exported as the JSONL header line so the report CLI can self-configure."""
    _tracer.meta.update(kv)


def _depth_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _ambient_tags() -> Optional[dict]:
    return getattr(_tls, "ambient", None)


def _cuda_event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def device_ms(sp: Span) -> float:
    """The card's milliseconds between a span's two events (the caller has
    synchronized)."""
    return sp.events[0].elapsed_time(sp.events[1])


# ---------------------------------------------------------------------------
# span context managers
# ---------------------------------------------------------------------------
class _NullSpan:
    """Shared no-op: what ``span()``/``annotate()`` return when disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kv):
        return self


NULL_SPAN = _NullSpan()


def _record_function(name: str):
    import torch
    return torch.profiler.record_function(name)


class _SpanCtx:
    __slots__ = ("name", "tags", "_t0_ns", "_ev0", "_prof_ctx")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.tags = tags
        self._t0_ns = 0
        self._ev0 = None
        self._prof_ctx = None

    def tag(self, **kv) -> "_SpanCtx":
        self.tags.update(kv)
        return self

    def __enter__(self):
        _depth_stack().append(self.name)
        if _profiler_annotations:
            self._prof_ctx = _record_function(self.name)
            self._prof_ctx.__enter__()
        if _device_events:
            self._ev0 = _cuda_event()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.perf_counter_ns()
        events = (self._ev0, _cuda_event()) if self._ev0 is not None else ()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        stack = _depth_stack()
        depth = len(stack) - 1
        if stack:
            stack.pop()
        amb = _ambient_tags()
        tags = {**amb, **self.tags} if amb else self.tags
        _tracer.record(Span(self.name,
                            (self._t0_ns - _tracer.epoch_ns) / 1e3,
                            (t1_ns - self._t0_ns) / 1e3,
                            threading.get_ident(), depth, tags, events))
        return False


def span(name: str, **tags):
    """Host-clock span: ``with span("codec/encode", level="inter") as sp:``.

    Disabled mode returns the shared :data:`NULL_SPAN`: no allocation beyond
    the call itself, no clock read.  ``sp.tag(nbytes=...)`` adds tags that
    are only known at exit time.
    """
    if not _enabled:
        return NULL_SPAN
    return _SpanCtx(name, tags)


def traced(name: Optional[str] = None, **tags):
    """Decorator flavor of :func:`span` (checks the flag per call)."""
    def deco(fn):
        sp_name = name or getattr(fn, "__qualname__", fn.__name__)

        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            with _SpanCtx(sp_name, dict(tags)):
                return fn(*a, **kw)

        wrapper.__name__ = getattr(fn, "__name__", sp_name)
        wrapper.__qualname__ = getattr(fn, "__qualname__", sp_name)
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


class _AmbientCtx:
    """Thread-local tags merged into every span recorded inside the block:
    how codec spans inherit the aggregation level they run under without the
    codec knowing about levels."""
    __slots__ = ("tags", "_prev")

    def __init__(self, tags: dict):
        self.tags = tags
        self._prev = None

    def __enter__(self):
        self._prev = _ambient_tags()
        merged = {**self._prev, **self.tags} if self._prev else self.tags
        _tls.ambient = merged
        return self

    def __exit__(self, *exc):
        _tls.ambient = self._prev
        return False


def ambient(**tags):
    """``with ambient(level="inter"):`` tags every span recorded within."""
    if not _enabled:
        return NULL_SPAN
    return _AmbientCtx(tags)


# ---------------------------------------------------------------------------
# torch.profiler passthrough
# ---------------------------------------------------------------------------
def annotate(name: str):
    """A ``torch.profiler.record_function`` range with no host span: the
    phase shows in a ``torch.profiler`` trace and costs no clock read of
    ours.  Returns the shared no-op when tracing is disabled."""
    if not _enabled:
        return NULL_SPAN
    return _record_function(name)


def step_annotation(step: int, name: str = "train"):
    """A ``record_function(f"{name}#{step}")`` range marking a round in a
    ``torch.profiler`` trace.  Only active when profiler annotations were
    opted into via ``enable(profiler_annotations=True)`` or
    ``REPRO_TRACE_PROFILER=1``."""
    if not (_enabled and _profiler_annotations):
        return NULL_SPAN
    return _record_function(f"{name}#{step}")


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def export_jsonl(path: str, tracer: Optional[Tracer] = None) -> str:
    """One JSON object per line: a ``{"type": "meta", ...}`` header (run
    metadata + eviction counters) followed by one ``span`` line per span."""
    tr = tracer or _tracer
    spans = tr.spans()
    with open(path, "w") as f:
        header = {"type": "meta", "n_recorded": tr.n_recorded,
                  "n_evicted": tr.n_evicted, "capacity": tr.capacity}
        header.update(tr.meta)
        f.write(json.dumps(header) + "\n")
        for s in spans:
            rec = s.to_json()
            rec["type"] = "span"
            f.write(json.dumps(rec) + "\n")
    return path


def load_jsonl(path: str) -> Tuple[dict, List[Span]]:
    """Inverse of :func:`export_jsonl`: (meta, spans)."""
    meta: dict = {}
    spans: List[Span] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type") == "meta":
                meta = {k: v for k, v in d.items() if k != "type"}
            else:
                spans.append(Span.from_json(d))
    return meta, spans


def export_chrome_trace(path: str, tracer: Optional[Tracer] = None) -> str:
    """Chrome ``chrome://tracing`` / Perfetto JSON: complete ("ph": "X")
    events with microsecond timestamps, span tags under ``args``."""
    tr = tracer or _tracer
    events = []
    for s in tr.spans():
        events.append({
            "name": s.name, "ph": "X", "cat": "repro",
            "ts": round(s.ts_us, 3), "dur": round(s.dur_us, 3),
            "pid": os.getpid(), "tid": s.tid,
            "args": {k: v for k, v in s.tags.items()},
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": dict(tr.meta)}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path
