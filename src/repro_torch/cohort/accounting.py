"""Per-cohort byte attribution: analytic class formulas, oracle-checked (the
port's copy of ``repro/cohort/accounting.py``).

At 10^5 leaves, encoding every client's payload to count bytes would cost
more than the round itself.  But every registered codec's wire size is a
*deterministic* function of the input dimension, so one probe encode per
(class, level) yields an exact per-message byte count, and a cohort round's
traffic is

    level 0:  sum_k  |survivors in class k| * class_k_message_bytes
    level l:  |survivors at level l|       * level_l_message_bytes

``materialized_round_bytes`` is the small-N oracle: it performs a real
``codecs.encode`` per message and must agree byte for byte with the
analytic attribution.  Ledger records tag each level by name (registered by
``TreeTopology``), with level-0 links split per link class.

Probe vectors are standard normals from a ``torch.Generator`` on the
accountant's device (the JAX package draws them with ``jax.random``); the
sizes do not depend on the values, so the bytes equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import codecs
from repro_torch.comm.accounting import PROBE_CAP
from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.tree import TreeTopology
from repro_torch.core.compressors import Compressor
from repro_torch.utils.device import fold_seed, make_generator, resolve_device

from repro_torch.cohort.population import LinkClass


def _probe_nbytes(c: Compressor, dim: int, gen: torch.Generator) -> int:
    """Wire bytes of one encode of a standard-normal probe drawn from ``gen``
    (which also feeds a stochastic compressor's draws)."""
    x = torch.randn((dim,), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return int(codecs.encode(c, x, generator=gen).nbytes)


def message_nbytes(c: Compressor, dim: int, seed: int = 0, device=None) -> int:
    """Exact wire bytes of one dim-sized message through compressor ``c``.

    Deterministic in ``dim`` for every registered compressor (plane shapes
    depend only on the input size), so one probe encode prices every message
    of the round.  ``dim`` must stay under the accounting probe cap.
    """
    if dim > PROBE_CAP:
        raise ValueError(f"dim {dim} exceeds the probe cap {PROBE_CAP}; "
                         "per-message bytes would no longer be probe-exact")
    return _probe_nbytes(c, dim, make_generator(seed, resolve_device(device)))


@dataclass(frozen=True)
class CohortRoundBytes:
    """One cohort round's uplink traffic, attributed per level and class."""
    round: int
    leaf_class_counts: Tuple[int, ...]   # surviving leaves per link class
    leaf_class_nbytes: Tuple[int, ...]   # total bytes per link class
    upper_counts: Tuple[int, ...]        # surviving senders per upper level
    upper_nbytes: Tuple[int, ...]        # total bytes per upper level

    @property
    def leaf_bytes(self) -> int:
        return int(sum(self.leaf_class_nbytes))

    @property
    def total_bytes(self) -> int:
        return self.leaf_bytes + int(sum(self.upper_nbytes))

    def by_level(self, tree: TreeTopology) -> Dict[str, int]:
        out = {tree.levels[0].name: self.leaf_bytes}
        for lev, b in zip(tree.levels[1:], self.upper_nbytes):
            out[lev.name] = int(b)
        return out


def _level_masks(tree: TreeTopology, survivor_masks) -> list:
    """Per-level boolean child masks (None = full participation)."""
    if survivor_masks is None:
        return [np.ones(tree.n_children(l), bool)
                for l in range(len(tree.levels))]
    return [np.asarray(m) > 0 for m in survivor_masks]


class CohortAccountant:
    """Prices cohort rounds analytically and records them into a ledger."""

    def __init__(self, tree: TreeTopology, classes: Sequence[LinkClass],
                 upper_compressors: Sequence[Compressor], dim: int,
                 device=None):
        if len(upper_compressors) != len(tree.levels) - 1:
            raise ValueError(
                f"{len(upper_compressors)} upper compressors for "
                f"{len(tree.levels) - 1} upper tree levels")
        device = resolve_device(device)
        self.tree = tree
        self.classes = tuple(classes)
        self.dim = int(dim)
        self.class_nbytes = tuple(
            message_nbytes(lc.make_compressor(), dim, device=device)
            for lc in self.classes)
        self.upper_nbytes = tuple(
            message_nbytes(c, dim, device=device) for c in upper_compressors)

    def uplink_time_s(self, class_ids: np.ndarray) -> np.ndarray:
        """Per-leaf nominal uplink time: each class's payload on its link."""
        times = np.array([lc.link.time_s(nb) for lc, nb in
                          zip(self.classes, self.class_nbytes)])
        return times[np.asarray(class_ids)]

    def round_bytes(self, rnd: int, class_ids: np.ndarray,
                    survivor_masks: Optional[Sequence[np.ndarray]]
                    ) -> CohortRoundBytes:
        """Analytic traffic of one round: class/level counts x message bytes.

        ``survivor_masks`` is the per-level child mask tuple from the fault
        plan (None = full participation).  Dead children send nothing: the
        ledger accounts *delivered* aggregation traffic, matching the oracle,
        which only encodes messages that reach a parent.
        """
        class_ids = np.asarray(class_ids)
        masks = _level_masks(self.tree, survivor_masks)
        counts = np.bincount(class_ids[masks[0]],
                             minlength=len(self.classes))
        return CohortRoundBytes(
            round=rnd,
            leaf_class_counts=tuple(int(c) for c in counts),
            leaf_class_nbytes=tuple(int(c * nb) for c, nb in
                                    zip(counts, self.class_nbytes)),
            upper_counts=tuple(int(m.sum()) for m in masks[1:]),
            upper_nbytes=tuple(int(m.sum()) * nb for m, nb in
                               zip(masks[1:], self.upper_nbytes)),
        )

    def record(self, ledger: CommLedger, rb: CohortRoundBytes) -> None:
        """Ledger the round: level-0 links split per class, tagged by level
        name (``TreeTopology.__post_init__`` registered the tags)."""
        leaf = self.tree.levels[0]
        for lc, nb in zip(self.classes, rb.leaf_class_nbytes):
            if nb:
                ledger.record(rb.round, f"{leaf.name}->up/{lc.name}", nb,
                              kind="inter", tag=leaf.name)
        for lev, nb in zip(self.tree.levels[1:], rb.upper_nbytes):
            if nb:
                ledger.record(rb.round, f"{lev.name}->up", nb,
                              kind="inter", tag=lev.name)


def materialized_round_bytes(rnd: int, class_ids: np.ndarray,
                             classes: Sequence[LinkClass],
                             upper_compressors: Sequence[Compressor],
                             tree: TreeTopology, dim: int,
                             survivor_masks: Optional[Sequence[np.ndarray]],
                             device=None) -> int:
    """Small-N oracle: encode every delivered message for real, sum bytes.

    O(cohort) codec calls — run it at N <= a few hundred to certify the
    analytic attribution, never in the hot path.  Sender ``i`` of level
    ``l`` encodes a probe drawn from a generator seeded from
    ``(1000 * l + rnd, i)``.
    """
    device = resolve_device(device)
    class_ids = np.asarray(class_ids)
    masks = _level_masks(tree, survivor_masks)
    comps = [lc.make_compressor() for lc in classes]
    total = 0
    for i in np.flatnonzero(masks[0]):
        gen = make_generator(fold_seed(rnd, int(i)), device)
        total += _probe_nbytes(comps[int(class_ids[i])], dim, gen)
    for l, c in enumerate(upper_compressors, start=1):
        for i in np.flatnonzero(masks[l]):
            gen = make_generator(fold_seed(1000 * l + rnd, int(i)), device)
            total += _probe_nbytes(c, dim, gen)
    return total
