"""Every idle gap of the card over one traced run of a benchmark cell, put
down to the program's spans.

A ``perf_bench/run.py --trace 1`` result names only the ten longest idle
gaps.  This runs one cell the same way, in one process, and keeps every gap
of the window:

* ``idle_by_inner_ms``: idle time summed by the innermost program span
  (``repro_torch.obs.trace``) open on the host where each gap begins,
  the rule ``perf_bench/harness/devtrace.py`` names its gaps by;
* ``top``: the longest gaps, each with the stack of spans open there and
  Python's garbage-collection pauses that overlap it (generation, ms);
* ``idle_in_gaps_under_50us_ms``: idle time in gaps shorter than 50 us,
  where the host launches kernels slower than the card runs them;
* ``gc_in_window``: the window's longest collections; ``alloc``: the
  caching allocator's retries, device mallocs and frees over the window.

    python scripts/idle_gaps.py --workload danube-train-efbv --seed 1 \\
        --seconds 51 --out gaps.json

Needs a CUDA card.  Prints a summary; ``--out`` gets the whole record.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perf_bench.harness import bench, devtrace  # noqa: E402

ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


class AllGaps(devtrace.DeviceTrace):
    """``DeviceTrace`` that also keeps every idle gap (``all_gaps``, host
    ns) and the allocator's counters over the window."""

    def __enter__(self):
        import torch
        self._mem0 = torch.cuda.memory_stats()
        return super().__enter__()

    def __exit__(self, *exc):
        import torch
        out = super().__exit__(*exc)
        mem1 = torch.cuda.memory_stats()
        self.alloc = {k: mem1.get(k, 0) - self._mem0.get(k, 0) for k in ALLOC_KEYS}
        return out

    def _read(self) -> None:
        from torch._C._autograd import DeviceType

        super()._read()
        busy, marker = [], None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = devtrace._ns(e, "start")
            if devtrace.MARKER in e.name() and marker is None:
                marker = a
                continue
            busy.append((a, a + devtrace._ns(e, "duration")))
        self.all_gaps = []
        if marker is None:
            return
        off = self._marker_host - marker
        lo, hi = self._host0, self._host1
        merged = [(max(a + off, lo), min(b + off, hi)) for a, b in devtrace.merge(busy)]
        edges = [lo] + [x for a, b in merged if b > a for x in (a, b)] + [hi]
        self.all_gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                         if edges[i + 1] > edges[i]]


def attribute(gaps, host_spans, pauses, lo):
    """Each gap (start, end) in host ns -> its record, longest first, and the
    idle ms summed by innermost span."""
    order = sorted(host_spans, key=lambda s: s[1])
    active, i, by_inner, out = [], 0, {}, []
    for a, b in sorted(gaps):
        while i < len(order) and order[i][1] <= a:
            active.append(order[i])
            i += 1
        active = [s for s in active if s[2] > a]
        open_ = sorted(active, key=lambda s: s[2] - s[1])     # innermost first
        inner = open_[0][0] if open_ else "outside"
        ms = (b - a) / 1e6
        by_inner[inner] = by_inner.get(inner, 0.0) + ms
        out.append({"t_s": (a - lo) / 1e9, "ms": ms, "inner": inner,
                    "stack": " > ".join(s[0] for s in reversed(open_)),
                    "gc": [[gen, (y - x) / 1e6] for x, y, gen in pauses if x < b and y > a]})
    out.sort(key=lambda g: -g["ms"])
    return out, dict(sorted(by_inner.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    bench.set_env()
    import torch
    torch.set_num_threads(1)
    pauses, start = [], {}

    def on_gc(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter_ns()
        else:
            pauses.append((start.get("t", 0), time.perf_counter_ns(), info["generation"]))

    gc.callbacks.append(on_gc)
    cell = bench.load_json("cells", args.workload)
    ctx = bench.Context(name=args.workload, cell=cell,
                        config=bench.load_json("configs", cell["config"]),
                        traffic=bench.load_json("traffic", cell["traffic"]),
                        seed=args.seed, seconds=args.seconds, trace=True,
                        device=torch.device("cuda", 0), t0=T0)
    driver = bench.load_py("drivers", cell["driver"])
    driver.DeviceTrace = AllGaps
    run = driver.run(ctx)
    gc.callbacks.remove(on_gc)

    tr = run.trace
    lo, hi = tr._host0, tr._host1
    window_gc = [(x, y, g) for x, y, g in pauses if lo <= x <= hi]
    gaps, by_inner = attribute(tr.all_gaps, run.series["host_spans"], window_gc, lo)
    res = {"workload": args.workload, "seed": args.seed, "window_s": tr.window_s,
           "busy_s": tr.busy_s, "n_gaps": len(gaps), "idle_ms": sum(g["ms"] for g in gaps),
           "idle_in_gaps_under_50us_ms": sum(g["ms"] for g in gaps if g["ms"] < 0.05),
           "idle_by_inner_ms": by_inner, "alloc": tr.alloc, "n_gc_in_window": len(window_gc),
           "gc_in_window": sorted(([g, (y - x) / 1e6] for x, y, g in window_gc),
                                  key=lambda p: -p[1])[:20],
           "top": gaps[:args.top], "numbers": run.numbers,
           "correct": bench.result_line(run, {}, {}, None)["correct"]}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res[k] for k in ("workload", "seed", "window_s", "busy_s", "n_gaps",
                                          "idle_ms", "idle_in_gaps_under_50us_ms", "alloc",
                                          "n_gc_in_window", "correct")}))
    print(json.dumps(by_inner))
    for g in gaps[:12]:
        print(json.dumps(g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
