"""The program's own spans (``repro_torch.obs.trace``), on in the traced run
only, with a CUDA event at each end, and the benchmark's own spans around
calls into a layer the program does not trace yet."""
from __future__ import annotations

from typing import List, Tuple


def enable(on: bool) -> None:
    from repro_torch.obs import trace
    if on:
        trace.enable(device_events=True)
    else:
        trace.disable()


def reset() -> None:
    from repro_torch.obs import trace
    trace.get_tracer().reset()


def collect() -> Tuple[List[tuple], List[tuple]]:
    """(spans as (name, host ms, device ms), spans as (name, host start ns,
    host end ns)) recorded since the last reset; the caller has
    synchronized the device."""
    from repro_torch.obs import trace
    tr = trace.get_tracer()
    out, host = [], []
    for sp in tr.spans():
        dev = trace.device_ms(sp) if sp.events else None
        out.append((sp.name, sp.dur_us / 1e3, dev))
        a = tr.epoch_ns + sp.ts_us * 1e3
        host.append((sp.name, a, a + sp.dur_us * 1e3))
    return out, host


def wrap(obj, attr: str, span_name: str) -> None:
    """Replace ``obj.attr`` (a function) by one that runs inside a program
    span of ``span_name``; the traced run's way of timing a call the
    program itself does not trace."""
    from repro_torch.obs import trace
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        with trace.span(span_name):
            return fn(*a, **kw)

    setattr(obj, attr, wrapped)
