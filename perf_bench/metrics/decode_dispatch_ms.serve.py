"""Host ms of one slot's decode call: the program's ``serve/slot/decode``
spans (the model's ``decode_step``, which enqueues the step's work and
returns), mean per slot call.  None where the program has no such span."""


def read(run):
    ms = [h for n, h, _ in run.spans if n == "serve/slot/decode"]
    return sum(ms) / len(ms) if ms else None
