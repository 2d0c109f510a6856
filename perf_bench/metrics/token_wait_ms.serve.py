"""Host ms the scheduler blocks on each decode step's tokens: the
program's ``serve/token/decode`` spans (the argmax read to the host, which
waits for the device to finish the step), mean.  None where the program
has no such span."""


def read(run):
    ms = [h for n, h, _ in run.spans if n == "serve/token/decode"]
    return sum(ms) / len(ms) if ms else None
