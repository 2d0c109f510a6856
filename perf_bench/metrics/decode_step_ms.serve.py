"""Device ms of one decode step of every live slot: the ``serve/decode``
spans, mean."""


def read(run):
    ms = run.span_ms("serve/decode")
    return sum(ms) / len(ms) if ms else None
