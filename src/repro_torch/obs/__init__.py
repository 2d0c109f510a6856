"""repro_torch.obs: observability for the comm stack (port of
``repro/obs``): the round-trace flight recorder, the metrics registry, and
measured-vs-modelled round reports.

Layers:
  trace    span API (``span("sync/encode", level="inter")`` as a context
           manager or decorator) over a monotonic clock and a thread-safe ring
           buffer acting as a flight recorder; exporters to per-round JSONL
           and Chrome ``chrome://tracing`` JSON; CUDA events at span ends on
           request, and an optional ``torch.profiler.record_function``
           passthrough so spans line up with ``torch.profiler`` traces.  Near-zero
           cost when disabled: the module-level flag short-circuits to a
           shared no-op span.
  metrics  counter/gauge/histogram registry with per-round time series; it
           ingests ``CommLedger.bytes_by_tag`` and per-level ``LevelCost``.
  report   joins a trace JSONL with the ``RoundCost`` model: measured
           wall-time per phase (pack -> encode -> allreduce -> decode ->
           adopt) next to the modelled times, and a per-level
           measured-bytes-vs-CommLedger audit.
           CLI: ``python -m repro_torch.obs.report TRACE.jsonl [--metrics M.json]``
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     registry)
from repro_torch.obs.trace import (Span, Tracer, ambient, annotate, disable,
                                   enable, enabled, export_chrome_trace,
                                   export_jsonl, get_tracer, load_jsonl,
                                   set_meta, span, step_annotation, traced)

__all__ = [
    "Span", "Tracer", "span", "traced", "ambient", "annotate",
    "step_annotation", "enable", "disable", "enabled", "get_tracer",
    "set_meta", "export_jsonl", "export_chrome_trace", "load_jsonl",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
]
