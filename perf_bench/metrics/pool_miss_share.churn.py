"""Misses over hits + misses of the block pool's acquires in the window, %."""


def read(run):
    h, m = run.numbers["hits"], run.numbers["misses"]
    return 100.0 * m / (h + m) if h + m else None
