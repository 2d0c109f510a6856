"""Kernel B3's (``unpack_dequant_kernel``) share of its bandwidth roofline
over the window's page-ins: each miss decodes the user's whole delta (5 B
an element + 4 B a row of 512) at 3.35 TB/s, over B3's device time."""
from perf_bench.metrics import counts


def read(run):
    if run.trace is None or not run.numbers["misses"]:
        return None
    n, secs = run.trace.kernel_s("unpack_dequant_kernel")
    if not n or secs <= 0:
        return None
    b = counts.b3_bytes(run.numbers["d"]) * run.numbers["misses"]
    return 100.0 * b / counts.HBM_BYTES_PER_S / secs
