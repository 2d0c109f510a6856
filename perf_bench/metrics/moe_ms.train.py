"""Device ms of a step's expert layers: the program's ``model/moe/forward``
spans (each layer's forward and its remat recompute: routing, dispatch, the
held experts, the combine and the shared expert) and ``model/moe/backward``
spans summed per step, mean over the window's steps.  None where the
program has no such span."""


def read(run):
    ms = run.span_ms("model/moe/forward") + run.span_ms("model/moe/backward")
    return sum(ms) / run.numbers["steps"] if ms else None
