"""Lossy-link transmission: seal -> send -> verify -> retry with backoff
(the port's copy of ``repro/faults/transmit.py``).

``transmit`` simulates one child->parent message on a faulty link: the
payload is sealed (CRC32 per plane, ``codecs.seal_payload``), each attempt
may be dropped or corrupted per the counter PRNG, and corrupted deliveries
are caught by ``verify_payload`` at the receiver and retransmitted after
exponential backoff.  Every attempt's bytes are charged to the
``CommLedger``: the first under the level's tag, retransmissions under
``"retry"``.

Attempt ``k`` of child ``c`` draws ``counter_uniform(seed, rnd,
"<level>/xmit", 1, lane=k * n_children + c)`` and decides with
``FaultModel.attempt_outcomes``'s rule (dropped below ``drop_rate``,
corrupted below ``drop_rate + corrupt_rate``).  Attempt 0 is therefore
``attempt_outcomes(rnd, level, 0)``'s draw for child ``c``, and attempt ``k``
is ``attempt_outcomes(rnd, level, 0, lanes=[k * n_children + c])``'s;
``attempt_outcomes(rnd, level, k)`` for ``k > 0`` reads per-attempt streams
(``<level>/xmit/a<k>``) instead, as in the JAX package.

A ``Payload``'s planes are numpy arrays, so sealing, the byte flip and the
checksums run on the host; ``repro_torch.comm`` is imported when a message
is sent (``comm.tree`` imports ``faults.model``).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.faults.model import FaultConfig, counter_uniform

# mirrors repro_torch.comm.ledger.RETRY_TAG; the tests pin the two equal
RETRY_TAG = "retry"


def expected_transmissions(loss_rate: float, max_retries: int) -> float:
    """E[attempts] with per-attempt loss ``q`` and up to ``max_retries``
    retransmissions: ``sum_{k=0..R} q^k``."""
    q = min(1.0, max(0.0, loss_rate))
    return sum(q ** k for k in range(max_retries + 1))


def corrupt_payload(p, rnd: int = 0, lane: int = 0, seed: int = 0):
    """Deterministically flip one byte of the payload's largest plane (in
    place).  Returns the name of the corrupted plane, or None if every plane
    is empty."""
    target = None
    for k, v in p.planes.items():
        if v.nbytes and (target is None or v.nbytes > p.planes[target].nbytes):
            target = k
    if target is None:
        return None
    buf = np.ascontiguousarray(p.planes[target]).view(np.uint8).copy()
    pos = int(counter_uniform(seed, rnd, "corrupt_at", 1, lane=lane)[0]
              * buf.size) % buf.size
    buf[pos] ^= np.uint8(0xFF)
    plane = p.planes[target]
    p.planes[target] = buf.view(plane.dtype).reshape(plane.shape)
    return target


@dataclass
class TransmitResult:
    delivered: bool
    attempts: int            # transmissions actually made
    n_dropped: int           # attempts lost in flight
    n_corrupt: int           # attempts delivered damaged (checksum caught)
    backoff_s: float         # total backoff waited before retries
    payload: Optional[object]  # the verified payload, or None if lost
    error: Optional[str] = None  # last PayloadError message, if any


def transmit(payload, cfg: FaultConfig, *, rnd: int, level_name: str,
             n_children: int, child: int, ledger=None, link: str = "",
             kind: str = "inter", phase: int = 0,
             tag: str = "") -> TransmitResult:
    """Send ``payload`` over ``level_name``'s link for child ``child``.

    A dropped attempt delivers nothing; a corrupted one delivers a byte-
    flipped copy that the receiver's ``verify_payload`` rejects.  Both
    trigger a retransmission after exponential backoff, up to
    ``cfg.max_retries`` retries.
    """
    from repro_torch.comm.codecs import PayloadError, seal_payload, verify_payload

    lf = cfg.link_faults(level_name)
    seal_payload(payload)
    base_tag = tag or level_name
    link = link or f"{level_name}/child{child}"
    n_dropped = n_corrupt = 0
    backoff_s = 0.0
    last_err: Optional[str] = None
    for attempt in range(cfg.max_retries + 1):
        if attempt > 0:
            backoff_s += cfg.backoff_s * cfg.backoff_mult ** (attempt - 1)
        if ledger is not None:
            ledger.record(rnd, link, payload.nbytes, kind=kind, phase=phase,
                          tag=base_tag if attempt == 0 else RETRY_TAG)
        lane = attempt * n_children + child
        u = float(counter_uniform(cfg.seed, rnd, f"{level_name}/xmit", 1,
                                  lane=lane)[0])
        if u < lf.drop_rate:
            n_dropped += 1
            continue
        if u < lf.drop_rate + lf.corrupt_rate:
            wire = copy.deepcopy(payload)
            hit = corrupt_payload(wire, rnd=rnd, lane=lane, seed=cfg.seed)
            if hit is None:  # nothing corruptible to flip: counts as a drop
                n_dropped += 1
                continue
            try:
                verify_payload(wire)
            except PayloadError as e:
                n_corrupt += 1
                last_err = str(e)
                continue
            raise AssertionError("corrupted plane passed checksum verify")
        verify_payload(payload)
        return TransmitResult(True, attempt + 1, n_dropped, n_corrupt,
                              backoff_s, payload, last_err)
    return TransmitResult(False, cfg.max_retries + 1, n_dropped, n_corrupt,
                          backoff_s, None, last_err)
