"""Device ms of one slot call's delta apply, from the program's own spans:
``serve/slot/eff`` (base + pool[table], f32) and ``serve/slot/debucketize``
(back to the model's tree), summed, over the count of ``serve/slot/eff``.
``delta_apply_ms.serve``'s definition; None where the program has no such
span."""


def read(run):
    eff = run.span_ms("serve/slot/eff")
    deb = run.span_ms("serve/slot/debucketize")
    return (sum(eff) + sum(deb)) / len(eff) if eff else None
