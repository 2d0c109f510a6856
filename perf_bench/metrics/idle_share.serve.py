"""The device's idle share of the serving window: 1 - the union of device
activity (torch.profiler) over the window's length, in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
