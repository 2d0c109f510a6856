"""Device ms of a step's clip + optimizer: the ``step/apply`` span, mean
over the window's steps."""


def read(run):
    ms = run.span_ms("step/apply")
    return sum(ms) / run.numbers["steps"] if ms else None
