"""Device ms of one refill: the ``serve/admit`` spans (admission, the
page-in of a missing user, the re-prefill of every live slot), mean."""


def read(run):
    ms = run.span_ms("serve/admit")
    return sum(ms) / len(ms) if ms else None
