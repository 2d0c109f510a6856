"""Device ms of a step's tiled attention: the program's
``model/attn/forward`` spans (each layer's forward and its remat
recompute) and ``model/attn/backward`` spans summed per step, mean over
the window's steps.  None where the program has no such span."""


def read(run):
    ms = run.span_ms("model/attn/forward") + run.span_ms("model/attn/backward")
    return sum(ms) / run.numbers["steps"] if ms else None
