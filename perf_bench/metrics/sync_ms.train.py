"""Device ms of a step's gradient sync: the ``step/sync`` spans (the
bucketize of each group's gradient and the EF-BV update) summed per step,
mean over the window's steps."""


def read(run):
    ms = run.span_ms("step/sync")
    return sum(ms) / run.numbers["steps"] if ms else None
