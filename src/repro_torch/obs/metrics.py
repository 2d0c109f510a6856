"""Metrics registry: counters/gauges/histograms with per-round time series
(the port's copy of ``repro/obs/metrics.py``).

The numeric side of the flight recorder: where ``trace`` captures *when*
things happened, this captures *how much* — bytes per aggregation level,
modelled round times, loss/grad-norm, cohort participation, fault counts —
as time series keyed by round.  The ingest hooks:

* :meth:`MetricsRegistry.observe_round_cost` — per-level ``LevelCost``
  byte/time gauges from a ``RoundCost``;
* :meth:`MetricsRegistry.ingest_ledger` — ``CommLedger`` record bytes per
  tag and per round as counters;
* :meth:`MetricsRegistry.ingest_tallies` — a trace's device tallies (the
  MoE layer's ``moe/held_rows`` and ``moe/tokens``) as counters;
* :meth:`MetricsRegistry.observe_fault_plan`,
  :meth:`MetricsRegistry.observe_cohort_round`,
  :meth:`MetricsRegistry.observe_train_step` and
  :meth:`MetricsRegistry.observe_serve` — the fault plan, the cohort
  engine's round report, the train loop's fetched metrics and the serving
  loop's stats.

Plain Python: values arrive as host floats, so nothing here synchronizes
the device.  ``to_dict`` / ``export_json`` give the machine-readable blob.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

HIST_WINDOW = 1024  # observations retained per histogram (flight-recorder)


class _Metric:
    kind = "metric"
    series_window: Optional[int] = None     # points kept in ``series``; None: all

    def __init__(self, name: str):
        self.name = name
        self.series: Deque[Tuple[Optional[int], float]] = deque(maxlen=self.series_window)

    def _note(self, step: Optional[int], value: float) -> None:
        self.series.append((step, float(value)))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "series": list(self.series)}


class Counter(_Metric):
    """Monotone accumulator (bytes shipped, spans recorded, ...); ``series``
    keeps the last ``HIST_WINDOW`` increments, ``total`` every one."""
    kind = "counter"
    series_window = HIST_WINDOW

    def __init__(self, name: str):
        super().__init__(name)
        self.total = 0.0

    def inc(self, value: float = 1.0, step: Optional[int] = None) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        self.total += float(value)
        self._note(step, value)

    @property
    def value(self) -> float:
        return self.total

    def to_dict(self) -> dict:
        return dict(super().to_dict(), total=self.total)


class Gauge(_Metric):
    """Last-write-wins value (bytes/round of a level, modeled time, loss);
    ``series`` keeps the last ``HIST_WINDOW`` writes."""
    kind = "gauge"
    series_window = HIST_WINDOW

    def __init__(self, name: str):
        super().__init__(name)
        self._value = 0.0

    def set(self, value: float, step: Optional[int] = None) -> None:
        self._value = float(value)
        self._note(step, value)

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return dict(super().to_dict(), value=self._value)


class Histogram(_Metric):
    """Windowed distribution (span durations, per-chunk bytes)."""
    kind = "histogram"

    def __init__(self, name: str, window: int = HIST_WINDOW):
        super().__init__(name)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window = deque(maxlen=window)

    def observe(self, value: float, step: Optional[int] = None) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._window.append(v)
        self._note(step, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the retained window (recent observations)."""
        if not self._window:
            return 0.0
        vals = sorted(self._window)
        idx = min(len(vals) - 1, max(0, round(q / 100.0 * (len(vals) - 1))))
        return vals[idx]

    def to_dict(self) -> dict:
        return dict(super().to_dict(), count=self.count, sum=self.sum,
                    min=self.min if self.count else None,
                    max=self.max if self.count else None, mean=self.mean)


class MetricsRegistry:
    """Name -> metric map with typed get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                                f"{cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}

    # -- comm-stack ingestion ----------------------------------------------
    def observe_round_cost(self, rnd: int, cost) -> None:
        """Per-level byte/time gauges from a ``RoundCost``.

        Hier/tree modes: one ``comm/bytes/<level>`` gauge per ``LevelCost``
        (their sum is exactly ``cost.total_bytes``).  Flat modes: the
        intra/inter split under the same prefix.  Modeled round times land
        under ``comm/model/...`` so the report can diff measured vs modeled.
        """
        if cost.levels:
            for lv in cost.levels:
                self.gauge(f"comm/bytes/{lv.name}").set(lv.bytes_per_round,
                                                        step=rnd)
                self.gauge(f"comm/model/time_s/{lv.name}").set(lv.time_s,
                                                               step=rnd)
        else:
            self.gauge("comm/bytes/intra").set(cost.intra_bytes, step=rnd)
            self.gauge("comm/bytes/inter").set(cost.inter_bytes, step=rnd)
        self.gauge("comm/model/round_time_s").set(cost.time_s, step=rnd)
        self.gauge("comm/model/serial_time_s").set(cost.serial_time_s,
                                                   step=rnd)
        self.gauge("comm/model/encoded_bits").set(cost.encoded_bits, step=rnd)

    def level_bytes(self) -> Dict[str, float]:
        """The ``comm/bytes/*`` gauges (per-level byte attribution)."""
        out = {}
        with self._lock:
            for name, m in self._metrics.items():
                if name.startswith("comm/bytes/") and isinstance(m, Gauge):
                    out[name[len("comm/bytes/"):]] = m.value
        return out

    def ingest_ledger(self, ledger) -> None:
        """Measured wire traffic from a ``CommLedger``: one counter per tag
        (``comm/ledger/<tag>``), incremented per record with the record's
        round as the series step, plus the per-round total."""
        for rec in ledger.records:
            tag = rec.tag or rec.kind
            self.counter(f"comm/ledger/{tag}").inc(rec.nbytes, step=rec.round)
        for rnd, nb in sorted(ledger.bytes_by_round().items()):
            self.counter("comm/ledger/total").inc(nb, step=rnd)

    def ledger_bytes(self) -> Dict[str, float]:
        """The ``comm/ledger/<tag>`` counter totals (measured bytes)."""
        out = {}
        with self._lock:
            for name, m in self._metrics.items():
                if (name.startswith("comm/ledger/") and name != "comm/ledger/total"
                        and isinstance(m, Counter)):
                    out[name[len("comm/ledger/"):]] = m.total
        return out

    def observe_fault_plan(self, rnd: int, plan) -> None:
        """Fault counters from a ``repro_torch.faults.RoundFaultPlan``: drops,
        retries, deadline misses, corruptions, unavailable clients as
        ``faults/*`` counters, plus the per-level survivor fraction and the
        degraded round completion time as gauges."""
        stats = plan.stats()
        for key in ("drops", "retries", "deadline_misses", "corrupt",
                    "unavailable"):
            self.counter(f"faults/{key}").inc(stats.get(key, 0.0), step=rnd)
        for lv in plan.levels:
            self.gauge(f"faults/survivor_frac/{lv.name}").set(
                lv.survivor_frac, step=rnd)
        self.gauge("faults/round_time_s").set(stats["time_s"], step=rnd)

    def observe_cohort_round(self, rnd: int, report) -> None:
        """Cohort-round series from a ``repro_torch.cohort.CohortRoundReport``:
        per-level/per-class byte counters (the analytic attribution), the
        participation count, and the sweep's scalar metrics — plus
        the round's fault plan through ``observe_fault_plan`` when the
        engine ran one."""
        rb = report.bytes
        self.counter("cohort/bytes/total").inc(rb.total_bytes, step=rnd)
        for i, nb in enumerate(rb.leaf_class_nbytes):
            self.counter(f"cohort/bytes/class_{i}").inc(nb, step=rnd)
        self.gauge("cohort/participants").set(report.n_participants,
                                              step=rnd)
        self.gauge("cohort/staged_nbytes").set(report.staged_nbytes,
                                               step=rnd)
        for k, v in report.metrics.items():
            self.gauge(f"cohort/{k}").set(float(v), step=rnd)
        if report.plan is not None:
            self.observe_fault_plan(rnd, report.plan)

    def fault_stats(self) -> Dict[str, float]:
        """The ``faults/*`` totals/values (empty when no faults observed)."""
        out = {}
        with self._lock:
            for name, m in self._metrics.items():
                if name.startswith("faults/"):
                    out[name[len("faults/"):]] = (
                        m.total if isinstance(m, Counter) else m.value)
        return out

    def observe_serve(self, stats, step: Optional[int] = None) -> None:
        """Serving-path bridge: a ``training.serving.ServeStats`` snapshot
        lands as ``serve/*`` gauges next to the pool's ``serve/pool/*``
        counters, so the obs report covers the serving plane."""
        for key in ("admitted", "completed", "decode_steps", "prefills",
                    "tokens_out"):
            self.gauge(f"serve/{key}").set(float(getattr(stats, key)),
                                           step=step)

    def serve_stats(self) -> Dict[str, float]:
        """The ``serve/*`` totals/values (empty when nothing served)."""
        out = {}
        with self._lock:
            for name, m in self._metrics.items():
                if name.startswith("serve/"):
                    out[name[len("serve/"):]] = (
                        m.total if isinstance(m, Counter) else m.value)
        return out

    def ingest_tallies(self, tracer) -> None:
        """The trace's device tallies (``obs.trace.Tracer.tallies``, e.g.
        ``moe/held_rows``) as counters: one host read of each, made only
        here, when a report or a benchmark asks."""
        for name, value in tracer.tallies().items():
            self.counter(name).inc(value)

    def observe_train_step(self, step: int, metrics: Dict[str, float]) -> None:
        """Loss/grad-norm (host-fetched floats) next to the byte series."""
        for k, v in metrics.items():
            self.gauge(f"train/{k}").set(float(v), step=step)

    # -- export -------------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            return {"metrics": [self._metrics[k].to_dict()
                                for k in sorted(self._metrics)]}

    def export_json(self, path: str, extra: Optional[dict] = None) -> str:
        doc = self.to_dict()
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return path


registry = MetricsRegistry()  # the default process-wide registry
