"""Counters and gauges with per-step series (a minimal copy of
``repro/obs/metrics.py``): what the block pool and the serving loop publish
under ``serve/*``.  Plain Python, no device sync.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class _Metric:
    kind = "metric"

    def __init__(self, name: str):
        self.name = name
        self.series: List[Tuple[Optional[int], float]] = []

    def _note(self, step: Optional[int], value: float) -> None:
        self.series.append((step, float(value)))


class Counter(_Metric):
    """Monotone accumulator."""
    kind = "counter"

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


class Gauge(_Metric):
    """Last-write-wins value."""
    kind = "gauge"

    def __init__(self, name: str):
        super().__init__(name)
        self._value = 0.0

    def set(self, value: float, step: Optional[int] = None) -> None:
        self._value = float(value)
        self._note(step, value)

    @property
    def value(self) -> float:
        return self._value


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
                raise TypeError(f"metric {name!r} is a {m.kind}, not a {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def observe_serve(self, stats, step: Optional[int] = None) -> None:
        """A ``training.serving.ServeStats`` snapshot as ``serve/*`` gauges."""
        for key in ("admitted", "completed", "decode_steps", "prefills",
                    "tokens_out"):
            self.gauge(f"serve/{key}").set(float(getattr(stats, key)), step=step)


registry = MetricsRegistry()  # the default process-wide registry
