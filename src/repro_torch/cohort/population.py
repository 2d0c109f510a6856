"""Population specs: million-client populations as pure functions (the
port's copy of ``repro/cohort/population.py``: numpy only, equal to the
reference bit for bit for the same spec).

A cross-device population is too large to materialize, so ``Population``
stores only the *law* of the population: a link-class mix drawn around the
topology's leaf level, a Dirichlet(alpha) data-skew knob, dataset-size and
personalization ranges.  Any client's realization derives on demand as a
pure function of ``(spec, client_id)`` through the counter PRNG of
``repro_torch.faults``.

Slicing invariance is the design contract: deriving specs for a sampled
cohort equals slicing the full-population derivation at those ids
(``client_spec(ids)[i] == client_spec([ids[i]])``), so the engine's memory
scales with the cohort, never the population.

* ``sample_cohort`` — a keyed Feistel permutation over the id domain with
  cycle-walking: ``cohort`` *distinct* client ids replayable from
  ``(seed, round)`` in O(cohort) time and memory.
* ``bucket_boundaries`` / ``bucket_by_size`` — the tensor2tensor
  ``data_reader`` bucketing idiom: cohort members are grouped into
  geometric size buckets with *static* padded capacities, so ragged
  per-client local-step counts become a few fixed-length loops instead of
  one padded to the population max.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from repro_torch.comm.topology import Link
from repro_torch.comm.tree import TreeTopology, get_tree_topology
from repro_torch.core import compressors as comp_lib
from repro_torch.core.compressors import Compressor
from repro_torch.data.federated import dirichlet_mixtures
# the population is addressed by the same counter PRNG as the fault
# processes: one mixer, one replay story ((seed, round, stream, lane))
from repro_torch.faults.model import (_GOLDEN, _mix64, counter_normal,
                                      counter_uniform)


# ---------------------------------------------------------------------------
# link classes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LinkClass:
    """One client link class: uplink physics + the uplink codec it can afford.

    Classes differ in *bytes*, not just time: a fiber client ships an int8
    quantized delta while a congested cell client ships a 1% top-k — the
    per-class byte formulas the cohort ledger attributes analytically.
    """
    name: str
    weight: float            # population fraction (weights sum to 1)
    link: Link
    compressor: str = "top_k"
    compress_ratio: float = 0.05
    quant_bits: int = 8

    def make_compressor(self) -> Compressor:
        return cohort_compressor(self.compressor, self.compress_ratio,
                                 self.quant_bits)


def cohort_compressor(name: str, compress_ratio: float,
                      quant_bits: int) -> Compressor:
    """Resolve a compressor name for the cohort sweep's stacked dense rows.

    Unlike ``make_sync_compressor``, ``qsgd`` resolves to the dense
    (``flatten=True``) quantizer: cohort leaves are stacked 1-D vectors, not
    2D-sharded model leaves, and the fused cascade (plus the per-class
    ``leaf_compress`` hook) requires flattenable operators.
    """
    if name == "qsgd":
        return comp_lib.qsgd(quant_bits)
    from repro_torch.core.distributed import make_sync_compressor

    c = make_sync_compressor(name, compress_ratio, quant_bits)
    if not c.flatten:
        raise ValueError(f"cohort compressor {name!r} is not flattenable "
                         "(sharding-safe variants cannot join the fused "
                         "cohort sweep)")
    return c


def link_classes_from_tree(tree: TreeTopology,
                           weights: Tuple[float, float, float] =
                           (0.2, 0.5, 0.3)) -> Tuple[LinkClass, ...]:
    """Three client classes drawn around ``tree``'s leaf (uplink) level.

    The middle class IS the preset uplink; "fiber" is ~16x faster and ships
    the dense fp32 delta uncompressed (the quant codec's 2 KiB block floor
    would cost more than dense at cohort-model dims), "cell" is 4x slower
    and ships a 1% top-k.  Weights are the population mix.
    """
    up = tree.levels[0].link
    return (
        LinkClass("fiber", weights[0],
                  Link(gbps=up.gbps * 16.0, latency_us=up.latency_us / 10.0),
                  compressor="identity"),
        LinkClass("broadband", weights[1], up,
                  compressor="top_k", compress_ratio=0.05),
        LinkClass("cell", weights[2],
                  Link(gbps=up.gbps / 4.0, latency_us=up.latency_us * 1.6),
                  compressor="top_k", compress_ratio=0.01),
    )


# ---------------------------------------------------------------------------
# cohort sampling — keyed Feistel permutation, O(cohort) not O(population)
# ---------------------------------------------------------------------------
def _feistel_perm(v: np.ndarray, base: np.uint64, half: int) -> np.ndarray:
    """4-round Feistel network on uint64 values < 2**(2*half) — a keyed
    bijection of the domain, vectorized over ``v``."""
    mask = np.uint64((1 << half) - 1)
    sh = np.uint64(half)
    left = v >> sh
    right = v & mask
    with np.errstate(over="ignore"):
        for r in range(4):
            f = _mix64(base + _GOLDEN * np.uint64(r + 1) + right) & mask
            left, right = right, left ^ f
    return (left << sh) | right


def sample_cohort(seed: int, rnd: int, n_population: int,
                  cohort: int) -> np.ndarray:
    """``cohort`` distinct client ids in [0, n_population), replayable from
    ``(seed, round)`` alone, in O(cohort) time and memory.

    A keyed Feistel permutation over the smallest even-bit domain covering
    the population maps ``0..cohort-1`` to distinct pseudo-random ids;
    out-of-range values cycle-walk (re-apply the bijection) back into range,
    which terminates because the domain is at most 4x the population.  No
    population-sized array is allocated — the property the engine's
    memory-scaling gate depends on.
    """
    if not 0 < cohort <= n_population:
        raise ValueError(f"cohort {cohort} outside (0, {n_population}]")
    bits = max(2, int(n_population - 1).bit_length())
    bits += bits % 2
    half = bits // 2
    with np.errstate(over="ignore"):
        base = _mix64(_GOLDEN * np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                      + np.uint64(rnd & 0xFFFFFFFFFFFFFFFF))
        base ^= np.uint64(zlib.crc32(b"cohort"))
    ids = _feistel_perm(np.arange(cohort, dtype=np.uint64), base, half)
    for _ in range(128):
        out = ids >= np.uint64(n_population)
        if not out.any():
            return ids.astype(np.int64)
        ids[out] = _feistel_perm(ids[out], base, half)
    raise RuntimeError("cycle walk did not converge")  # unreachable: bijection


# ---------------------------------------------------------------------------
# size bucketing (tensor2tensor data_reader idiom)
# ---------------------------------------------------------------------------
def bucket_boundaries(max_size: int, min_size: int = 8,
                      step: float = 1.25) -> Tuple[int, ...]:
    """Geometric bucket boundaries ``min_size <= b_0 < ... <= max_size``.

    A client with ``m`` local samples runs in the smallest bucket with
    ``boundary >= m``, so each bucket's scan length is its boundary — the
    padded-shape schedule tensor2tensor's ``_bucket_boundaries`` uses for
    ragged sequence lengths.
    """
    if not 1 <= min_size <= max_size:
        raise ValueError(f"need 1 <= min_size <= max_size, got "
                         f"[{min_size}, {max_size}]")
    if step <= 1.0:
        raise ValueError(f"step must be > 1, got {step}")
    out, x = [], int(min_size)
    while x < max_size:
        out.append(x)
        x = max(x + 1, int(x * step))
    out.append(int(max_size))
    return tuple(out)


def bucket_capacities(boundaries: Tuple[int, ...], cohort: int,
                      samples_min: int, samples_max: int,
                      slack: float = 0.2, floor: int = 8) -> Tuple[int, ...]:
    """Static per-bucket capacities for a cohort of uniform[min, max] sizes.

    Capacity = expected occupancy + binomial headroom (4 sigma) + ``floor``;
    capacities come from the population's size *law*, not the realized
    cohort, so a round's shapes (and staged bytes) do not depend on which
    clients were sampled.  Rare overflow spills
    into the next (larger) bucket — see ``bucket_by_size``.
    """
    span = samples_max - samples_min + 1
    caps, lo = [], samples_min - 1
    for b in boundaries:
        hi = min(b, samples_max)
        p = max(0, hi - lo) / span
        lo = hi
        mean = cohort * p
        caps.append(min(cohort, int(np.ceil(mean * (1.0 + slack)
                                            + 4.0 * np.sqrt(max(mean, 1.0))
                                            + floor))))
    return tuple(caps)


@dataclass(frozen=True)
class CohortBuckets:
    """Cohort slots partitioned into padded size buckets.

    ``index[b]`` holds cohort-slot indices padded to the bucket's static
    capacity with -1; ``valid[b]`` marks real entries.  Every cohort slot
    appears in exactly one bucket.
    """
    boundaries: Tuple[int, ...]
    index: Tuple[np.ndarray, ...]
    valid: Tuple[np.ndarray, ...]

    @property
    def padded_steps(self) -> int:
        """Total scan work (sum of capacity * boundary) — the quantity
        bucketing minimizes vs one max-padded batch."""
        return sum(len(ix) * b for ix, b in zip(self.index, self.boundaries))


def bucket_by_size(sizes: np.ndarray, boundaries: Tuple[int, ...],
                   capacities: Tuple[int, ...]) -> CohortBuckets:
    """Assign each cohort slot to the smallest bucket covering its size.

    Overflow beyond a bucket's static capacity spills into the next larger
    bucket (always correct — a longer scan still covers the member, just
    with more masked steps); exhausting the top bucket raises, which the
    4-sigma headroom in ``bucket_capacities`` makes effectively impossible.
    """
    sizes = np.asarray(sizes)
    if sizes.size and int(sizes.max()) > boundaries[-1]:
        raise ValueError(f"size {int(sizes.max())} exceeds the top boundary "
                         f"{boundaries[-1]}")
    want = np.searchsorted(np.asarray(boundaries), sizes, side="left")
    idx_out, val_out = [], []
    carry = np.zeros(0, np.int64)
    for b, cap in enumerate(capacities):
        members = np.concatenate([carry, np.flatnonzero(want == b)])
        take, carry = members[:cap], members[cap:]
        idx = np.full(cap, -1, np.int64)
        idx[: take.shape[0]] = take
        idx_out.append(idx)
        val_out.append(idx >= 0)
    if carry.size:
        raise RuntimeError(
            f"bucket capacities exhausted: {carry.size} cohort member(s) "
            "unplaced — raise bucket_capacities slack")
    return CohortBuckets(tuple(boundaries), tuple(idx_out), tuple(val_out))


# ---------------------------------------------------------------------------
# the population law
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ClientSpecBatch:
    """Realized spec of a batch of clients (all derived, nothing stored)."""
    ids: np.ndarray            # (n,) population ids
    class_ids: np.ndarray      # (n,) index into Population.classes
    targets: np.ndarray        # (n, dim) float32 local optima x_i*
    flix_alpha: np.ndarray     # (n,) float32 Scafflix personalization mix
    n_samples: np.ndarray      # (n,) int32 local dataset size


@dataclass(frozen=True)
class Population:
    """The law of a client population; every field is O(1) in n_clients.

    Per-client data follows the dissertation's S2 skew: client i's class
    mixture is Dirichlet(alpha) (``dirichlet_mixtures``), its local optimum
    the mixture-weighted combination of shared class prototypes — alpha ->
    inf gives IID clients (all targets at the prototype mean), alpha -> 0
    one-class clients.  FLIX personalization mixes and local dataset sizes
    are uniform in their ranges; link classes follow ``classes`` weights.
    """
    n_clients: int
    dim: int = 32
    n_classes: int = 10
    alpha: float = 0.3
    tree: str = "edge_fl_tree"
    classes: Tuple[LinkClass, ...] = ()
    seed: int = 0
    samples_min: int = 8
    samples_max: int = 64
    flix_min: float = 0.25
    flix_max: float = 1.0

    def __post_init__(self):
        if self.n_clients < 1 or self.dim < 1 or self.n_classes < 1:
            raise ValueError("n_clients, dim, n_classes must be >= 1")
        if not 1 <= self.samples_min <= self.samples_max:
            raise ValueError(f"bad sample range [{self.samples_min}, "
                             f"{self.samples_max}]")
        if not 0.0 <= self.flix_min <= self.flix_max <= 1.0:
            raise ValueError(f"flix range [{self.flix_min}, {self.flix_max}] "
                             "outside [0, 1]")
        if not self.classes:
            object.__setattr__(
                self, "classes",
                link_classes_from_tree(get_tree_topology(self.tree)))
        w = sum(lc.weight for lc in self.classes)
        if not np.isclose(w, 1.0):
            raise ValueError(f"class weights sum to {w}, expected 1")

    # -- lane-addressed derivations (pure in (spec, client_id)) --------------
    def _ids(self, ids) -> np.ndarray:
        if np.ndim(ids) == 0:
            ids = np.arange(int(ids))
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_clients):
            raise ValueError(f"client ids outside [0, {self.n_clients})")
        return ids

    def link_class_ids(self, ids) -> np.ndarray:
        ids = self._ids(ids)
        u = counter_uniform(self.seed, 0, "pop/class", ids.shape[0], lane=ids)
        cum = np.cumsum([lc.weight for lc in self.classes])
        cum[-1] = 1.0  # guard float roundoff at the top edge
        return np.searchsorted(cum, u, side="right").astype(np.int32)

    def prototypes(self) -> np.ndarray:
        """Shared (n_classes, dim) class prototypes — the only population-
        level tensor, and it is O(classes), not O(clients)."""
        z = counter_normal(self.seed, 0, "pop/proto",
                           self.n_classes * self.dim)
        return (z.reshape(self.n_classes, self.dim)
                / np.sqrt(self.dim)).astype(np.float32)

    def mixtures(self, ids) -> np.ndarray:
        return dirichlet_mixtures(self._ids(ids), self.n_classes, self.alpha,
                                  seed=self.seed)

    def targets(self, ids) -> np.ndarray:
        """Per-client local optimum: mixture-weighted prototype blend."""
        return (self.mixtures(ids) @ self.prototypes()).astype(np.float32)

    def flix_alpha(self, ids) -> np.ndarray:
        ids = self._ids(ids)
        u = counter_uniform(self.seed, 0, "pop/flix", ids.shape[0], lane=ids)
        return (self.flix_min
                + u * (self.flix_max - self.flix_min)).astype(np.float32)

    def n_samples(self, ids) -> np.ndarray:
        ids = self._ids(ids)
        u = counter_uniform(self.seed, 0, "pop/m", ids.shape[0], lane=ids)
        span = self.samples_max - self.samples_min + 1
        return (self.samples_min
                + np.minimum((u * span).astype(np.int64), span - 1)
                ).astype(np.int32)

    def client_spec(self, ids) -> ClientSpecBatch:
        ids = self._ids(ids)
        return ClientSpecBatch(
            ids=ids,
            class_ids=self.link_class_ids(ids),
            targets=self.targets(ids),
            flix_alpha=self.flix_alpha(ids),
            n_samples=self.n_samples(ids),
        )

    def class_mix_counts(self, ids) -> np.ndarray:
        """(n_link_classes,) realized class occupancy of ``ids``."""
        return np.bincount(self.link_class_ids(ids),
                           minlength=len(self.classes))
