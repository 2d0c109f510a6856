"""Deterministic fault model: availability, stragglers, and lossy links.

(The port's copy of ``repro/faults/model.py``: numpy only, the same
values for the same seed.)

Every round in the repo used to assume perfect infrastructure — all clients
arrive, every link delivers every byte, aggregation waits forever.  The
dissertation's cross-device chapters (Cohort-Squeeze, Scafflix's client
sampling) treat partial participation and heterogeneous, unreliable clients
as the *normal* case; this module makes that the simulator's vocabulary:

* **availability** — each leaf client independently checks in per round;
* **stragglers** — a straggling client's compute/link time is multiplied by
  a lognormal slowdown ``exp(sigma * |z|)``;
* **per-link faults** — each message on a tree level's link may be dropped,
  corrupted (caught by the codec checksum, then retransmitted), or delayed;
* **deadlines** — an aggregator at level ``l`` waits at most ``deadline_s``
  for its children, then aggregates over the survivors.

All randomness is a *counter-based* PRNG (splitmix64 finalizer over
``(seed, round, stream, lane)``), so any round's decisions replay bit-exactly
from ``(seed, round)`` alone — no sequential generator state to keep in step
between runs, and round ``t`` can be re-examined without replaying rounds
``0..t-1``.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPLIT1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLIT2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x) -> np.ndarray:
    """splitmix64 finalizer — a bijective avalanche on uint64 counters
    (modular uint64 arithmetic: wraparound is the point, not an overflow)."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, np.uint64).copy()
        z ^= z >> np.uint64(30)
        z *= _SPLIT1
        z ^= z >> np.uint64(27)
        z *= _SPLIT2
        z ^= z >> np.uint64(31)
        return z


def counter_uniform(seed: int, rnd: int, stream: str, n: int,
                    lane=0) -> np.ndarray:
    """``n`` uniforms in [0, 1) addressed by ``(seed, round, stream, lane+i)``.

    Pure function of its arguments: the same address always yields the same
    draw, and distinct streams/rounds/lanes are decorrelated by the mixer.

    ``lane`` is either a scalar offset (draws address lanes ``lane..lane+n-1``)
    or an explicit ``(n,)`` array of lane indices — the cohort engine's form:
    drawing a 10^6-lane process sliced to any index set equals drawing those
    lanes directly, because each draw depends on its own lane address alone.
    """
    with np.errstate(over="ignore"):
        base = _mix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                      + _GOLDEN * np.uint64(rnd & 0xFFFFFFFFFFFFFFFF))
        base ^= np.uint64(zlib.crc32(stream.encode()))
        lane = np.asarray(lane, dtype=np.uint64)
        if lane.ndim == 0:
            lanes = (np.arange(n, dtype=np.uint64) + lane) * _GOLDEN
        else:
            if lane.shape != (n,):
                raise ValueError(f"lane array shape {lane.shape} != ({n},)")
            lanes = lane * _GOLDEN
        bits = _mix64(base + lanes)
    # top 53 bits -> double in [0, 1)
    return (bits >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def counter_normal(seed: int, rnd: int, stream: str, n: int,
                   lane=0) -> np.ndarray:
    """Standard normals via Box-Muller on two counter-uniform streams."""
    u1 = counter_uniform(seed, rnd, stream + "/u1", n, lane)
    u2 = counter_uniform(seed, rnd, stream + "/u2", n, lane)
    r = np.sqrt(-2.0 * np.log1p(-u1))  # 1-u1 in (0, 1], log finite
    return r * np.cos(2.0 * math.pi * u2)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LinkFaults:
    """Per-message fault rates of one link class."""
    drop_rate: float = 0.0     # message silently lost in flight
    corrupt_rate: float = 0.0  # payload mangled (codec checksum catches it)
    delay_rate: float = 0.0    # message stalled by an extra ``delay_s``
    delay_s: float = 0.0

    @property
    def loss_rate(self) -> float:
        """Probability one transmission attempt fails (drop OR corrupt)."""
        return min(1.0, self.drop_rate + self.corrupt_rate)

    def any(self) -> bool:
        return (self.drop_rate > 0 or self.corrupt_rate > 0
                or (self.delay_rate > 0 and self.delay_s > 0))


@dataclass(frozen=True)
class LevelFaults:
    """Override for one named tree level (rates + deadline)."""
    name: str
    drop_rate: Optional[float] = None
    corrupt_rate: Optional[float] = None
    delay_rate: Optional[float] = None
    delay_s: Optional[float] = None
    deadline_s: Optional[float] = None


@dataclass(frozen=True)
class FaultConfig:
    """Seedable fault-injection knobs (``SyncConfig.faults``).

    Defaults are all-off: ``FaultConfig()`` is the perfect-infrastructure
    round, and every consumer treats ``enabled() == False`` as "take the
    exact legacy code path" so a disabled config stays bit-identical to no
    config at all.
    """
    seed: int = 0
    availability: float = 1.0       # P(leaf client checks in this round)
    straggler_rate: float = 0.0     # fraction of clients straggling
    straggler_sigma: float = 1.0    # lognormal sigma of the slowdown
    drop_rate: float = 0.0          # default per-link message loss
    corrupt_rate: float = 0.0       # default per-link payload corruption
    delay_rate: float = 0.0         # default per-link stall probability
    delay_s: float = 0.0            # stall duration when delayed
    deadline_s: float = math.inf    # default per-level aggregation deadline
    levels: Optional[Tuple[LevelFaults, ...]] = None  # per-level overrides
    max_retries: int = 2            # retransmissions after a lost attempt
    backoff_s: float = 0.05         # first retry backoff
    backoff_mult: float = 2.0       # exponential backoff multiplier

    def enabled(self) -> bool:
        """True when any fault process can actually fire."""
        base = (self.availability < 1.0
                or (self.straggler_rate > 0 and self.straggler_sigma > 0)
                or self.drop_rate > 0 or self.corrupt_rate > 0
                or (self.delay_rate > 0 and self.delay_s > 0)
                or math.isfinite(self.deadline_s))
        if base:
            return True
        for lf in self.levels or ():
            if any(v for v in (lf.drop_rate, lf.corrupt_rate, lf.delay_rate)):
                return True
            if lf.deadline_s is not None and math.isfinite(lf.deadline_s):
                return True
        return False

    def _override(self, name: str) -> Optional[LevelFaults]:
        for lf in self.levels or ():
            if lf.name == name:
                return lf
        return None

    def has_override(self, level_name: str) -> bool:
        return self._override(level_name) is not None

    def link_faults(self, level_name: str) -> LinkFaults:
        """Effective per-message fault rates on ``level_name``'s link."""
        ov = self._override(level_name)
        pick = (lambda o, d: d if o is None else o)
        if ov is None:
            return LinkFaults(self.drop_rate, self.corrupt_rate,
                              self.delay_rate, self.delay_s)
        return LinkFaults(pick(ov.drop_rate, self.drop_rate),
                          pick(ov.corrupt_rate, self.corrupt_rate),
                          pick(ov.delay_rate, self.delay_rate),
                          pick(ov.delay_s, self.delay_s))

    def level_deadline_s(self, level_name: str) -> float:
        ov = self._override(level_name)
        if ov is not None and ov.deadline_s is not None:
            return ov.deadline_s
        return self.deadline_s

    def backoff_total_s(self, attempts_after_first: int) -> float:
        """Total backoff waited before ``attempts_after_first`` retries."""
        t, b = 0.0, self.backoff_s
        for _ in range(max(0, attempts_after_first)):
            t += b
            b *= self.backoff_mult
        return t

    def expected_transmissions(self, loss_rate: float) -> float:
        """E[attempts] under up-to-``max_retries`` retransmissions.

        Attempt k happens iff the first k attempts all failed:
        ``sum_{k=0..R} q^k`` — the retry-tagged ledger bytes are
        ``(E[attempts] - 1) * payload``.
        """
        q = min(1.0, max(0.0, loss_rate))
        return sum(q ** k for k in range(self.max_retries + 1))


# ---------------------------------------------------------------------------
# round plans
# ---------------------------------------------------------------------------
@dataclass
class LevelPlan:
    """One level's fault outcome for one round (children = child nodes)."""
    name: str
    survivors: np.ndarray        # bool (n_children,) — made the deadline
    arrival_s: np.ndarray        # per-child arrival time at the parent
    deadline_s: float
    n_unavailable: int           # leaves only: did not check in
    n_dead_subtree: int          # aggregators with zero surviving descendants
    n_dropped: int               # lost after exhausting retries
    n_deadline_miss: int         # arrived too late (straggle/delay/backoff)
    n_corrupt: int               # corrupted attempts (caught + retried)
    n_retries: int               # retransmission attempts on this level
    time_s: float                # level completion: min(deadline, max arrival)

    @property
    def n_children(self) -> int:
        return int(self.survivors.shape[0])

    @property
    def survivor_frac(self) -> float:
        return float(self.survivors.mean()) if self.survivors.size else 1.0


@dataclass
class RoundFaultPlan:
    """All levels' fault outcomes for one round — replayable from
    ``(seed, round)`` and directly consumable by ``tree_param_sync``."""
    round: int
    levels: List[LevelPlan] = field(default_factory=list)

    def survivor_masks(self) -> Tuple[np.ndarray, ...]:
        """float32 per-level child masks for the degraded sync paths."""
        return tuple(lv.survivors.astype(np.float32) for lv in self.levels)

    @property
    def time_s(self) -> float:
        """Degraded round completion: levels aggregate bottom-up in series."""
        return sum(lv.time_s for lv in self.levels)

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "drops": sum(lv.n_dropped for lv in self.levels),
            "deadline_misses": sum(lv.n_deadline_miss for lv in self.levels),
            "retries": sum(lv.n_retries for lv in self.levels),
            "corrupt": sum(lv.n_corrupt for lv in self.levels),
            "unavailable": sum(lv.n_unavailable for lv in self.levels),
            "time_s": self.time_s,
        }
        for lv in self.levels:
            out[f"survivor_frac/{lv.name}"] = lv.survivor_frac
        return out


class FaultModel:
    """A ``FaultConfig`` bound to an aggregation tree's levels.

    ``tree`` is a ``repro_torch.comm.tree.TreeTopology`` (duck-typed: ``levels``
    with ``name``/``fanout``/``link``, and ``n_leaves``).  A flat topology is
    the depth-1 tree whose single level fans out over all clients.

    Every decision is drawn from the counter PRNG keyed by
    ``(cfg.seed, round, "<level>/<process>", child_index)``, so two models
    built from the same config produce identical plans for the same round —
    the replay property the acceptance criteria pin down.
    """

    def __init__(self, cfg: FaultConfig, tree):
        self.cfg = cfg
        self.tree = tree
        # child counts per level, leaf-most first: level 0's children are the
        # leaves; level l's children are the level-(l-1) aggregators
        self.n_children = []
        n = tree.n_leaves
        for lev in tree.levels:
            self.n_children.append(n)
            n //= lev.fanout

    def link_faults_at(self, level: int) -> LinkFaults:
        """Effective rates at ``level`` — defers to the tree's resolution
        (config override > attached level default > config globals) when the
        topology implements it (``TreeTopology.level_faults``)."""
        resolve = getattr(self.tree, "level_faults", None)
        if resolve is not None:
            return resolve(level, self.cfg)
        return self.cfg.link_faults(self.tree.levels[level].name)

    def _lanes(self, level: int, lanes) -> Tuple[int, np.ndarray]:
        """Resolve optional explicit lane indices to ``(n, lane_array)``.

        ``lanes=None`` addresses the level's children positionally
        (``0..n_children-1``); an explicit array addresses global lanes (the
        cohort engine passes population-wide client ids for level 0), making
        every per-child draw sliceable: the draw for lane ``i`` never depends
        on which other lanes are in the plan.
        """
        if lanes is None:
            n = self.n_children[level]
            return n, np.arange(n, dtype=np.uint64)
        lanes = np.asarray(lanes, dtype=np.uint64)
        return int(lanes.shape[0]), lanes

    # -- per-process draws ---------------------------------------------------
    def available(self, rnd: int, lanes=None) -> np.ndarray:
        """Leaf check-in mask for this round (availability process)."""
        n, lane = self._lanes(0, lanes)
        u = counter_uniform(self.cfg.seed, rnd, "avail", n, lane=lane)
        return u < self.cfg.availability

    def straggler_scale(self, rnd: int, level: int, lanes=None) -> np.ndarray:
        """Per-child slowdown multiplier (>= 1) at ``level``."""
        n, lane = self._lanes(level, lanes)
        name = self.tree.levels[level].name
        if self.cfg.straggler_rate <= 0 or self.cfg.straggler_sigma <= 0:
            return np.ones(n)
        hit = counter_uniform(self.cfg.seed, rnd, f"{name}/straggle", n,
                              lane=lane)
        z = np.abs(counter_normal(self.cfg.seed, rnd, f"{name}/stragglez", n,
                                  lane=lane))
        return np.where(hit < self.cfg.straggler_rate,
                        np.exp(self.cfg.straggler_sigma * z), 1.0)

    def attempt_outcomes(self, rnd: int, level: int, attempt: int,
                         lanes=None) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """(dropped, corrupted, delayed) masks for one transmission attempt
        of every child message on ``level`` — retries redraw via ``attempt``.

        Each attempt is its own stream (``<level>/xmit/a<k>`` for retries)
        rather than a lane offset of ``attempt * n``: offsetting by ``n``
        made retry draws depend on the population size, which would break the
        lane-sliceability contract above.
        """
        n, lane = self._lanes(level, lanes)
        name = self.tree.levels[level].name
        lf = self.link_faults_at(level)
        sfx = "" if attempt == 0 else f"/a{attempt}"
        u = counter_uniform(self.cfg.seed, rnd, f"{name}/xmit{sfx}", n,
                            lane=lane)
        dropped = u < lf.drop_rate
        corrupted = (~dropped) & (u < lf.drop_rate + lf.corrupt_rate)
        ud = counter_uniform(self.cfg.seed, rnd, f"{name}/delay{sfx}", n,
                             lane=lane)
        delayed = ud < lf.delay_rate
        return dropped, corrupted, delayed

    # -- the full round ------------------------------------------------------
    def level_plan(self, rnd: int, level: int, base_time_s,
                   alive: np.ndarray, lanes=None) -> LevelPlan:
        """Fault outcome of one level's child->parent messages.

        ``alive`` marks children that have anything to send (available
        leaves, or aggregators with >= 1 surviving descendant);
        ``base_time_s`` is the nominal per-child message time on the level's
        link — a scalar, or a per-child array when children ride
        heterogeneous links (the cohort engine's per-class uplinks).  A child
        survives iff it is alive, its message is delivered within
        ``max_retries`` retransmissions, and its arrival time — straggle *
        base + delays + retry backoffs — makes the deadline.  ``lanes``
        addresses the per-child draws explicitly (see ``_lanes``).
        """
        lev = self.tree.levels[level]
        lf = self.link_faults_at(level)
        deadline = self.cfg.level_deadline_s(lev.name)
        alive = np.asarray(alive, bool)
        n = alive.shape[0]
        base_time_s = np.asarray(base_time_s, float)

        scale = self.straggler_scale(rnd, level, lanes=lanes)
        arrival = base_time_s * scale
        delivered = np.zeros(n, bool)
        n_corrupt = n_retries = 0
        pending = alive.copy()
        for attempt in range(self.cfg.max_retries + 1):
            if not pending.any():
                break
            if attempt > 0:
                n_retries += int(pending.sum())
                arrival = np.where(
                    pending,
                    arrival + self.cfg.backoff_s
                    * self.cfg.backoff_mult ** (attempt - 1)
                    + base_time_s * scale,
                    arrival)
            dropped, corrupted, delayed = self.attempt_outcomes(
                rnd, level, attempt, lanes=lanes)
            n_corrupt += int((pending & corrupted).sum())
            arrival = np.where(pending & delayed, arrival + lf.delay_s,
                               arrival)
            ok = pending & ~dropped & ~corrupted
            delivered |= ok
            pending &= ~ok
        lost = alive & ~delivered
        made_deadline = delivered & (arrival <= deadline)
        survivors = made_deadline
        time_s = float(min(deadline, arrival[survivors].max())
                       if survivors.any() else
                       (deadline if math.isfinite(deadline)
                        else np.max(base_time_s)))
        return LevelPlan(
            name=lev.name, survivors=survivors,
            arrival_s=np.where(alive, arrival, np.inf),
            deadline_s=deadline,
            n_unavailable=int((~alive).sum()) if level == 0 else 0,
            n_dead_subtree=int((~alive).sum()) if level > 0 else 0,
            n_dropped=int(lost.sum()),
            n_deadline_miss=int((delivered & ~made_deadline).sum()),
            n_corrupt=n_corrupt, n_retries=n_retries, time_s=time_s)

    def round_plan(self, rnd: int,
                   nbytes_by_level: Optional[Sequence[float]] = None,
                   leaf_lanes=None, leaf_base_time_s=None) -> RoundFaultPlan:
        """Full per-level fault plan for one round.

        ``nbytes_by_level[l]`` sizes the nominal per-child message on level
        ``l`` (defaults to 0 — latency-only base times).  An aggregator is
        alive at level ``l`` iff at least one of its children survived level
        ``l-1``, so dead subtrees propagate up the cascade.

        ``leaf_lanes`` (optional, length ``n_leaves``) addresses the leaf
        processes by *global* lane index instead of position — the cohort
        engine passes the sampled clients' population ids, so a cohort's
        leaf-level plan is exactly the corresponding slice of the full
        population's plan.  ``leaf_base_time_s`` (scalar or per-leaf array)
        overrides level 0's nominal message time, letting heterogeneous
        client link classes set their own uplink times; upper levels are
        infrastructure and keep positional lanes.
        """
        plan = RoundFaultPlan(round=rnd)
        if leaf_lanes is not None:
            leaf_lanes = np.asarray(leaf_lanes)
            if leaf_lanes.shape[0] != self.n_children[0]:
                raise ValueError(
                    f"leaf_lanes has {leaf_lanes.shape[0]} lanes but the "
                    f"tree has {self.n_children[0]} leaves")
        alive = self.available(rnd, lanes=leaf_lanes)
        for l, lev in enumerate(self.tree.levels):
            nbytes = (float(nbytes_by_level[l])
                      if nbytes_by_level is not None else 0.0)
            base_s = lev.link.time_s(nbytes)
            if l == 0 and leaf_base_time_s is not None:
                base_s = leaf_base_time_s
            lp = self.level_plan(rnd, l, base_s, alive,
                                 lanes=leaf_lanes if l == 0 else None)
            plan.levels.append(lp)
            # parents with >= 1 surviving child carry the subtree upward
            f = lev.fanout
            alive = lp.survivors.reshape(-1, f).any(axis=1)
        return plan
