"""Run one cell of the benchmark once and print its result as the last line.

    python perf_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
same cell with the program's spans (CUDA events at both ends) and a
``torch.profiler`` trace of the device over the window, and prints its
per-layer metrics, each read by ``perf_bench/metrics/<name>.py``.  Every run
ends with the comparison that decides ``correct``: each number compared is
printed beside its limit on standard error and under ``checks`` in the
result.  ``--control 1`` (not used by the benchmark's own runs) also runs
the reference in float8 and puts it in the program's place: ``checks`` and
``correct`` are then the control's under the same limits, and the
program's own checks print before them on standard error.

Exits non-zero, printing no result, without the cards the cell asks for,
or if JAX, Flax or the JAX package (``repro``) were loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perf_bench.harness import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench.set_env()
    man = bench.manifest()
    wl = bench.workload(man, args.workload)
    import torch
    torch.set_num_threads(1)        # one process, few threads: steadier host timing
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = bench.load_json("cells", args.workload)
    ctx = bench.Context(name=args.workload, cell=cell,
                        config=bench.load_json("configs", cell["config"]),
                        traffic=bench.load_json("traffic", cell["traffic"]),
                        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                        device=torch.device("cuda", 0), t0=T0, control=bool(args.control))
    torch.cuda.reset_peak_memory_stats()
    run = bench.load_py("drivers", cell["driver"]).run(ctx)

    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    if args.trace:
        metrics = {}
        for m in bench.per_layer(man, args.workload):
            v = bench.load_py("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": run.metrics[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(man, args.workload)}
    device = bench.device_info(wl["chips"], run.memory_peak_bytes)
    breakdown = None
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps(run.series.get("host_spans"))}
    bad = bench.forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad[:8]}", file=sys.stderr)
        return 3
    print("numbers " + json.dumps(run.numbers), file=sys.stderr)
    if args.control:
        bench.print_checks(run.checks, "program")
    bench.print_checks(run.control if args.control else run.checks)
    print(json.dumps(bench.result_line(run, metrics, device, breakdown, bool(args.control))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
