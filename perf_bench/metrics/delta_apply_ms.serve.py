"""Device ms of one slot call's delta apply: the benchmark's spans around
``DeltaServeEngine.delta_eff`` (base + pool[table], f32) and the
``debucketize`` back to the model's tree, summed per slot call, mean."""


def read(run):
    eff = run.span_ms("bench/delta_eff")
    deb = run.span_ms("bench/debucketize")
    return (sum(eff) + sum(deb)) / len(eff) if eff else None
