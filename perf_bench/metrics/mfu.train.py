"""The whole step's share of the card's bf16 peak: model flops of the
window's steps (``counts.train_step_flops``: forward + backward of every
weight product, causal attention once, no recomputation) over the window
times 989.4 TFLOP/s, in %."""
from perf_bench.metrics import counts


def read(run):
    tr = run.traffic
    f = counts.train_step_flops(run.config, tr["seq_len"], tr["global_batch"])
    return 100.0 * f * run.numbers["steps"] / run.window_s / counts.PEAK_FLOPS_BF16
