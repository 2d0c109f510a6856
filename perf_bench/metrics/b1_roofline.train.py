"""Kernel B1's (``quant_kernel<false>``) share of its bandwidth roofline in
the window: the bytes B1 must move for every group's d-element delta of
every window step (12 B an element), at 3.35 TB/s, over B1's device time."""
from perf_bench.metrics import counts


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernel_s("quant_kernel<false>")
    if not n or secs <= 0:
        return None
    elems = run.cell["sync"]["groups"] * run.numbers["d"] * run.numbers["steps"]
    return 100.0 * counts.b1_bytes(elems) / counts.HBM_BYTES_PER_S / secs
