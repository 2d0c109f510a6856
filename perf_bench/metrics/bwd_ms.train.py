"""Device ms of a step's backward passes: the program's
``step/grad/backward`` spans (one per group, ``autograd.grad`` with the
remat recompute) summed per step, mean over the window's steps.  None
where the program has no such span."""


def read(run):
    ms = run.span_ms("step/grad/backward")
    return sum(ms) / run.numbers["steps"] if ms else None
