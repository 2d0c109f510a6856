"""One run of a benchmark training cell with a fault planted under the
program's train step, to read how far the cell's comparison puts a broken
step from the program's own readings at the cell's full size:

* ``half_batch``: each step sees the first half of its rows twice;
* ``unchanged``: each step leaves the parameters and Adam's moments as
  they were (kept on the host between steps: a copy on the card would not
  fit beside a full-size step).

The CPU tests (``perf_bench/tests/test_perfbench_faults.py``) plant the
same faults at a small size.

The run is ``perf_bench/run.py``'s; its checks print on standard error
and its result line, ``correct`` among it, last.

    python scripts/train_faults.py --fault half_batch -- \\
        --workload granite-train-efbv --seed 1 --seconds 3

Needs a CUDA card.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perf_bench import run as bench_run  # noqa: E402  (its clock starts here)
from perf_bench.tests.test_perfbench_faults import _half_batch  # noqa: E402


def unchanged(step):
    from repro_torch.utils.tree import tree_leaves

    def f(state, batch, survivors=None, noise=None):
        leaves = lambda: tree_leaves((state.params, state.opt_state.mu,  # noqa: E731
                                      state.opt_state.nu))
        held = [t.to("cpu", copy=True) for t in leaves()]
        _, met = step(state, batch, noise=noise)
        for t, h in zip(leaves(), held):
            t.copy_(h)
        return state, met
    return f


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", choices=("half_batch", "unchanged"), required=True)
    ap.add_argument("run_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    from repro_torch.training import steps
    real, wrap = steps.make_train_step, {"half_batch": _half_batch, "unchanged": unchanged}
    steps.make_train_step = lambda *a, **kw: wrap[args.fault](real(*a, **kw))
    rest = args.run_args[1:] if args.run_args[:1] == ["--"] else args.run_args
    return bench_run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
