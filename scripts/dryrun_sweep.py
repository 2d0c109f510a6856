"""The dry-run's full-width sweep: the ``launch.dryrun`` CLI over a list of
cells, one process per cell, ``--workers`` at a time (each traces on the
host's CPU; nothing runs on a card).

Cells: every config x ``train_4k`` and x ``decode_32k`` (dense), mamba2-2.7b
x ``train_4k`` under efbv, and danube / mamba2 x ``prefill_32k``.  Each
record lands under ``--out``; one summary line per cell (status, trace_s,
the process's wall seconds, per-rank argument and peak bytes, collective
counts) is printed and written to ``summary.txt`` there.  ``--cells``
runs the named cells only (``arch/shape/sync[/mp]``, comma-separated; a
fourth field ``mp`` takes the (2, 16, 16) mesh, none the (16, 16) one).

Usage:
  python scripts/dryrun_sweep.py --workers 6 --out results/dryrun_sweep
  python scripts/dryrun_sweep.py --workers 3 --out results/moe \
      --cells dbrx-132b/train_4k/dense,jamba-1.5-large-398b/train_4k/dense
  python scripts/dryrun_sweep.py --workers 2 --out results/mp \
      --cells mamba2-2.7b/decode_32k/dense/mp,mamba2-2.7b/long_500k/dense
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = ["qwen1.5-110b", "chameleon-34b", "mamba2-2.7b", "nemotron-4-15b", "qwen1.5-4b",
         "h2o-danube-1.8b", "seamless-m4t-large-v2", "jamba-1.5-large-398b", "dbrx-132b",
         "llama4-scout-17b-a16e"]
CELLS = ([(a, "train_4k", "dense", False) for a in ARCHS]
         + [("mamba2-2.7b", "train_4k", "efbv", False)]
         + [(a, "decode_32k", "dense", False) for a in ARCHS]
         + [("h2o-danube-1.8b", "prefill_32k", "dense", False),
            ("mamba2-2.7b", "prefill_32k", "dense", False)])
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def parse_cell(text: str) -> tuple:
    """``arch/shape/sync[/mp]`` -> (arch, shape, sync, multi_pod)."""
    arch, shape, sync, *mp = text.split("/")
    if mp not in ([], ["mp"]):
        raise ValueError(f"cell {text!r}: the fourth field is 'mp' or absent")
    return arch, shape, sync, bool(mp)


def one(cell, out: str) -> str:
    arch, shape, sync, mp = cell
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--sync", sync, "--out", out,
                        "--multi-pod", "multi" if mp else "single"],
                       capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                       timeout=3000)
    wall = time.time() - t
    try:
        with open(os.path.join(out, f"{arch}__{shape}__{'mp' if mp else 'sp'}__{sync}.json")) as f:
            rec = json.load(f)
    except OSError:
        rec = {"status": "no record", "error": r.stderr[-1500:]}
    mem = rec.get("memory", {})
    peak = mem.get("peak_bytes")
    mesh = "2x16x16" if mp else "16x16"
    return (f"{arch} x {shape} x {mesh} x {sync}: {rec['status']} trace_s {rec.get('trace_s')} "
            f"process_s {wall:.1f} args {mem.get('argument_size_in_bytes')} peak {peak} "
            f"({(peak or 0) / 2**30:.2f} GiB) collectives {json.dumps(rec.get('collectives'))} "
            f"{(rec.get('error') or rec.get('reason') or '')[:300]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun_sweep")
    ap.add_argument("--cells", default="",
                    help="arch/shape/sync[/mp],...; empty = every cell")
    args = ap.parse_args()
    cells = [parse_cell(c) for c in args.cells.split(",") if c] or CELLS
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(args.workers) as ex:
        lines = []
        for line in ex.map(lambda c: one(c, args.out), cells):
            print(line, flush=True)
            lines.append(line)
    tail = f"wall {time.time() - t0:.1f} s, {args.workers} workers"
    print(tail, flush=True)
    with open(os.path.join(args.out, "summary.txt"), "w") as f:
        f.write("\n".join(lines) + "\n" + tail + "\n")


if __name__ == "__main__":
    main()
