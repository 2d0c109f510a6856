"""Device ms of a step's forward + backward: the ``step/grad`` spans (one
per group) summed per step, mean over the window's steps."""


def read(run):
    ms = run.span_ms("step/grad")
    return sum(ms) / run.numbers["steps"] if ms else None
