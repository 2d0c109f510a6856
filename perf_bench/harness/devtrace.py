"""The device's timeline over the measured window, from ``torch.profiler``
(CUPTI activity on the card only: kernels, copies, sets).

``busy_s`` is the union of device activity inside the window and
``window_s`` the window's host length; each kernel's time is summed by
name.  A marker kernel launched at a known host time ties the device's
clock to the host's, so each idle gap is named after the innermost program
span (``repro_torch.obs.trace``) open on the host where the gap begins.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"


def _ns(e, which: str) -> float:
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, which + "_us")()) * 1e3


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.kernels: Dict[str, List[float]] = {}     # name -> [count, seconds]
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: List[Tuple[float, float]] = []     # host ns (start, end), longest first
        self._host0 = 0
        self._host1 = 0
        self._marker_host = 0

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        self._host0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._host1 = time.perf_counter_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        self.prof = None
        return False

    def _read(self) -> None:
        from torch._C._autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        spans = []
        marker = None
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            a = _ns(e, "start")
            b = a + _ns(e, "duration")
            name = e.name()
            if MARKER in name and marker is None:
                marker = a
                continue
            spans.append((a, b))
            k = self.kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e9
        self.window_s = (self._host1 - self._host0) / 1e9
        if marker is None:           # no clock tie: the busy union alone
            merged = merge(spans)
            self.busy_s = sum(b - a for a, b in merged) / 1e9
            return
        off = self._marker_host - marker        # device ns -> host ns
        lo, hi = self._host0, self._host1
        merged = [(max(a + off, lo), min(b + off, hi)) for a, b in merge(spans)]
        merged = [(a, b) for a, b in merged if b > a]
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]

    def kernel_s(self, substring: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``substring``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if substring in name:
                n += c
                s += t
        return n, s

    def device_ops(self, top: int = 10) -> List[list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return [[name[:160], t] for name, (_, t) in ops]

    def idle_gaps(self, host_spans: Optional[List[Tuple[str, float, float]]] = None) -> List[list]:
        """The longest idle gaps, each named after the innermost host span
        (name, start ns, end ns) open where it begins."""
        out = []
        for a, b in self.gaps:
            label = "outside the program's spans"
            best = None
            for name, s0, s1 in host_spans or ():
                if s0 <= a < s1 and (best is None or s1 - s0 < best):
                    label, best = name, s1 - s0
            out.append([label, (b - a) / 1e9])
        return out
