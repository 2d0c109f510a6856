"""The cohort engine: one federated round over 10^5-10^6 clients (the port's
copy of ``repro/cohort/engine.py``).

A round — broadcast, per-client FLIX/Scafflix local steps, per-class
compressed uplink, the full anchor cascade — runs as one sweep over stacked
per-client state on the engine's device:

* clients exist only while sampled (``sample_cohort`` Feistel ids +
  ``Population.client_spec`` lane derivations), so host and device memory
  scale with the cohort, never the population;
* ragged local-step counts run as one fixed-length loop per size bucket
  (tensor2tensor-style), each step masked per client, instead of one loop
  padded to the population max;
* heterogeneous link classes compress through ``tree_param_sync``'s
  ``leaf_compress`` hook: one batched pass per class over all leaf rows,
  blended by the one-hot class matrix, while metro/WAN levels run the stock
  cascade;
* participation comes from ``FaultModel.round_plan`` addressed by the
  sampled clients' *population* ids (``leaf_lanes``), so every round —
  cohort, faults and sweep draws — replays from ``(seed, round)`` alone.

Semantics are the *stateless-client* cross-device model: a sampled client
starts from its cell aggregator's anchor.  With full participation the
sweep equals driving a per-client loop on the same cohort bit for bit.

Differences from the JAX package, none of which changes a value: the sweep
is a Python loop of torch operations, not one jitted function, each written
as the reference's separate operations (no fused multiply-add); the round's
draws, which only stochastic link classes make, come from ``noise=`` or a
generator seeded from ``(pop.seed, round)``; the engine takes ``device=``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.tree import TreeTopology, get_tree_topology
from repro_torch.core import compressors as comp_lib
from repro_torch.core import distributed as dist
from repro_torch.core.compressors import Compressor
from repro_torch.core.distributed import CascadeLevel, TreeSyncState
from repro_torch.faults.model import FaultConfig, FaultModel, RoundFaultPlan
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import fold_seed, make_generator, resolve_device

from repro_torch.cohort.accounting import CohortAccountant, CohortRoundBytes
from repro_torch.cohort.population import (CohortBuckets, LinkClass,
                                           Population, bucket_boundaries,
                                           bucket_by_size, bucket_capacities,
                                           cohort_compressor, sample_cohort)


def flix_local_step(x, target, alpha, lr):
    """One FLIX/Scafflix local step on the quadratic client objective.

    The client's personalized model is ``x~ = alpha*x + (1-alpha)*x_i*``;
    its local loss ``0.5*||x~ - x_i*||^2`` has gradient
    ``alpha*(x~ - x_i*)`` in ``x``, so the step contracts ``x`` toward the
    local optimum at rate ``lr * alpha^2``.  Elementwise, so the batched
    sweep and a per-client loop produce bitwise-identical iterates.
    """
    x_t = alpha * x + (1.0 - alpha) * target
    return x - lr * (alpha * (x_t - target))


def _draw(noise, i):
    return None if noise is None else noise[i]


@dataclass
class CohortRoundReport:
    """Everything one engine round produced besides the new state."""
    round: int
    cohort_ids: np.ndarray
    class_ids: np.ndarray
    bytes: CohortRoundBytes
    plan: Optional[RoundFaultPlan]
    staged_nbytes: int           # host bytes staged for the sweep (O(cohort))
    padded_steps: int            # total scan work after bucketing
    metrics: Dict[str, float] = field(default_factory=dict)

    @property
    def n_participants(self) -> int:
        if self.plan is None:
            return int(self.cohort_ids.shape[0])
        return int(self.plan.levels[0].survivors.sum())


class CohortEngine:
    """A ``Population`` bound to a cohort size: rounds as batched sweeps on
    ``device`` (``None`` -> the card).

    ``cohort_size`` leaves occupy ``pop.tree`` rescaled via
    ``with_n_leaves``; the anchor cascade runs the population's per-class
    compressors at the leaf hop and ``upper_compressors`` (default: dense
    middle hops, 1% top-k on the WAN root hop) above, all periods 1 — every
    round is a full cascade sync.
    """

    def __init__(self, pop: Population, cohort_size: int, lr: float = 0.1,
                 fault_config: Optional[FaultConfig] = None,
                 upper_compressors: Optional[Sequence[Compressor]] = None,
                 ledger: Optional[CommLedger] = None, metrics=None,
                 device=None):
        self.device = resolve_device(device)
        self.pop = pop
        self.cohort_size = int(cohort_size)
        self.lr = float(lr)
        self.ledger = ledger
        self.metrics = metrics
        base = get_tree_topology(pop.tree)
        self.tree: TreeTopology = base.with_n_leaves(self.cohort_size)

        if upper_compressors is None:
            # middle hops ship the dense aggregate; the top (WAN) hop
            # sparsifies hard — each slower link carries a more compressed
            # payload
            upper_compressors = tuple(
                cohort_compressor("top_k", 0.01, 8) if l == base.depth - 1
                else cohort_compressor("identity", 0.05, 8)
                for l in range(1, base.depth))
        self.upper_compressors = tuple(upper_compressors)
        self.class_compressors = tuple(lc.make_compressor()
                                       for lc in pop.classes)
        self.cascade = self._build_cascade()
        self.accountant = CohortAccountant(self.tree, pop.classes,
                                           self.upper_compressors, pop.dim,
                                           device=self.device)
        self.fault_model = (FaultModel(fault_config, self.tree)
                            if fault_config is not None else None)

        self.boundaries = bucket_boundaries(pop.samples_max,
                                            min_size=pop.samples_min)
        self.capacities = bucket_capacities(
            self.boundaries, self.cohort_size, pop.samples_min,
            pop.samples_max)

    def _build_cascade(self) -> Tuple[CascadeLevel, ...]:
        def lam_of(c: Compressor) -> float:
            return (comp_lib.lambda_star(c.eta, c.omega)
                    if c.eta is not None and c.omega is not None else 1.0)

        # heterogeneous leaves: the mean mixes per-class operators, so take
        # the most conservative class step size (min lambda_star contracts
        # for every class; equals the single class's lambda when K == 1)
        lam0 = min(lam_of(c) for c in self.class_compressors)
        leaf_c = (self.class_compressors[0]
                  if len(self.class_compressors) == 1
                  else comp_lib.identity())  # placeholder: leaf_compress wins
        out = [CascadeLevel(self.tree.levels[0].name, leaf_c, lam0, 1,
                            self.tree.levels[0].fanout)]
        for lev, c in zip(self.tree.levels[1:], self.upper_compressors):
            out.append(CascadeLevel(lev.name, c, lam_of(c), 1, lev.fanout))
        return tuple(out)

    # -- per-round derivations -----------------------------------------------
    def round_generator(self, rnd: int) -> torch.Generator:
        """The round's draws when no ``noise`` is given (stochastic link or
        upper-level compressors only)."""
        return make_generator(fold_seed(self.pop.seed, rnd), self.device)

    def init_state(self) -> TreeSyncState:
        return dist.tree_sync_state_init(
            {"x": torch.zeros((self.pop.dim,), dtype=torch.float32,
                              device=self.device)}, self.cascade)

    def round_cohort(self, rnd: int) -> np.ndarray:
        return sample_cohort(self.pop.seed, rnd, self.pop.n_clients,
                             self.cohort_size)

    def round_plan(self, rnd: int, ids: np.ndarray,
                   class_ids: np.ndarray) -> Optional[RoundFaultPlan]:
        """Fault plan addressed by population ids: the cohort's leaf draws
        are the population plan's slice at ``ids`` (lane-sliceability)."""
        if self.fault_model is None:
            return None
        nbytes = [0.0] + list(self.accountant.upper_nbytes)
        return self.fault_model.round_plan(
            rnd, nbytes_by_level=nbytes, leaf_lanes=ids,
            leaf_base_time_s=self.accountant.uplink_time_s(class_ids))

    def buckets(self, n_samples: np.ndarray) -> CohortBuckets:
        return bucket_by_size(n_samples, self.boundaries, self.capacities)

    # -- the sweep -----------------------------------------------------------
    def _local_steps(self, x, targets, a_col, steps, buckets):
        """Ragged FLIX local training, one fixed-length loop per size bucket:
        gather the bucket's rows (pads clipped to row 0), run ``boundary``
        masked steps, scatter back only the valid rows."""
        for boundary, (idx, rows, pos) in zip(self.boundaries, buckets):
            safe = idx.clamp(0, x.shape[0] - 1)
            xb, tb, ab, mb = x[safe], targets[safe], a_col[safe], steps[safe]
            for s in range(boundary):
                nxt = flix_local_step(xb, tb, ab, self.lr)
                xb = torch.where((s < mb)[:, None], nxt, xb)
            x[rows] = xb[pos]
        return x

    def _leaf_compress(self, onehot):
        """The leaf hop's ``leaf_compress``: each class's compressor in one
        row-wise pass over all (G, d) rows, blended by the one-hot class
        matrix in class order (rows are one-hot, so this is per-client
        dispatch).  ``noise``, when given, is one (G, ...) draw stack per
        class (None for deterministic ones)."""
        fns = [c.fn for c in self.class_compressors]

        def leaf_compress(delta_b, d, noise, generator):
            flat = delta_b.view(delta_b.shape[0], -1)
            core = flat[:, :d]
            if len(fns) == 1:
                out = fns[0](core, _draw(noise, 0), generator)
            else:
                out = torch.zeros_like(core)
                for k, fn in enumerate(fns):
                    out = out + onehot[:, k, None] * fn(
                        core, _draw(noise, k), generator)
            flat[:, :d] = out
            return delta_b
        return leaf_compress

    # -- the round -----------------------------------------------------------
    def round(self, state: TreeSyncState, rnd: int, noise=None
              ) -> Tuple[TreeSyncState, CohortRoundReport]:
        """One round.  ``noise`` (optional) is ``tree_param_sync``'s draw
        structure, its level-0 entry one (G, ...) stack per link class; when
        None, stochastic compressors draw from ``round_generator(rnd)``."""
        dev = self.device
        with obs_trace.span("cohort/spec", round=rnd):
            ids = self.round_cohort(rnd)
            spec = self.pop.client_spec(ids)
            cb = self.buckets(spec.n_samples)
        with obs_trace.span("cohort/plan", round=rnd):
            plan = self.round_plan(rnd, ids, spec.class_ids)
            smasks = plan.survivor_masks() if plan is not None else None

        onehot = np.zeros((self.cohort_size, len(self.pop.classes)),
                          np.float32)
        onehot[np.arange(self.cohort_size), spec.class_ids] = 1.0
        steps = spec.n_samples.astype(np.int32)
        staged = [spec.targets, spec.flix_alpha, steps, onehot,
                  *cb.index, *cb.valid] + (list(smasks)
                                           if smasks is not None else [])
        staged_nbytes = int(sum(a.nbytes for a in staged))

        with obs_trace.span("cohort/stage", round=rnd):
            # every host array goes over before any device work is queued
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            targets, alphas, steps_t, onehot_t = (
                put(spec.targets), put(spec.flix_alpha), put(steps),
                put(onehot))
            buckets = [(put(ix), put(ix[v]), put(np.flatnonzero(v)))
                       for ix, v in zip(cb.index, cb.valid)]
            masks = (tuple(put(m) for m in smasks)
                     if smasks is not None else None)

        with obs_trace.span("cohort/local", round=rnd):
            # broadcast: every sampled client starts from its cell anchor
            # (stateless clients); in a depth-1 cascade the only anchor is
            # the unstacked root
            a0 = state.anchors[0]["x"]
            a0 = a0[None] if a0.dim() == 1 else a0
            x = torch.repeat_interleave(a0, self.cascade[0].fanout, dim=0)
            x = self._local_steps(x, targets, alphas[:, None], steps_t,
                                  buckets)
            d_local = x - targets
            target_dist = torch.sqrt(torch.mean(torch.sum(d_local ** 2,
                                                          dim=1)))
            del d_local

        gen = self.round_generator(rnd) if noise is None else None
        with obs_trace.span("cohort/sync", round=rnd):
            _, new_state = dist.tree_param_sync(
                {"x": x}, state, self.cascade, bucket_size=self.pop.dim,
                survivors=masks, leaf_compress=self._leaf_compress(onehot_t),
                noise=noise, generator=gen)
        root = new_state.anchors[-1]["x"]
        vals = torch.stack([target_dist, torch.sqrt(torch.sum(root ** 2))])
        tdist, rnorm = vals.tolist()

        rb = self.accountant.round_bytes(rnd, spec.class_ids, smasks)
        if self.ledger is not None:
            self.accountant.record(self.ledger, rb)
        report = CohortRoundReport(
            round=rnd, cohort_ids=ids, class_ids=spec.class_ids, bytes=rb,
            plan=plan, staged_nbytes=staged_nbytes,
            padded_steps=cb.padded_steps,
            metrics={"target_dist": tdist, "root_norm": rnorm})
        if self.metrics is not None:
            self.metrics.observe_cohort_round(rnd, report)
        return new_state, report

    def run(self, n_rounds: int, state: Optional[TreeSyncState] = None
            ) -> Tuple[TreeSyncState, list]:
        state = self.init_state() if state is None else state
        reports = []
        for rnd in range(n_rounds):
            state, rep = self.round(state, rnd)
            reports.append(rep)
        return state, reports
