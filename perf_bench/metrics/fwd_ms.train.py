"""Device ms of a step's forward passes: the program's ``step/grad/forward``
spans (one per group, the loss) summed per step, mean over the window's
steps.  None where the program has no such span."""


def read(run):
    ms = run.span_ms("step/grad/forward")
    return sum(ms) / run.numbers["steps"] if ms else None
