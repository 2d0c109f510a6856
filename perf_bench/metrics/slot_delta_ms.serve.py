"""Device ms of one slot call's delta apply, mean, from the program's own
spans: ``serve/slot/eff`` (``DeltaServeEngine.delta_eff``: base +
pool[table], f32) and ``serve/slot/debucketize`` (its cast back into the
engine's parameter tree), summed over the window, over the count of
``serve/slot/eff``; None where the program has no such span."""


def read(run):
    eff = run.span_ms("serve/slot/eff")
    deb = run.span_ms("serve/slot/debucketize")
    return (sum(eff) + sum(deb)) / len(eff) if eff else None
