"""Host-side training loop: data feed, step, metrics, checkpoints (port of
``repro/training/loop.py``).

The round report (bytes per round from ``core.distributed.round_comm``, the
modelled time on the configured topology preset) is logged once at the
start; under ``qsgd_kernel`` its probe encode runs kernel B2.  Metrics stay
on the device and are fetched only at log points and once at the end,
never with a per-step ``.item()`` — unless tracing is on
(``repro_torch.obs.trace``), when, as in the JAX loop, every step's metrics
are fetched (``round/blocking_fetch``) and the process-wide
``repro_torch.obs.registry`` receives the round cost
(``observe_round_cost``), each step's fault plan (``observe_fault_plan``)
and each step's fetched metrics (``observe_train_step``), and the
``train`` logger (``utils.logging``) emits the reference's structured
``round step=... loss=...`` line.  Each round is a ``round/step`` span and,
with profiler annotations on, a ``train#<step>`` ``torch.profiler`` range.
Wall times come from ``obs.trace.wall_s``, the trace's clock.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import init_params
from repro_torch.obs import registry
from repro_torch.obs import trace as obs_trace
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.steps import init_train_state, make_train_step
from repro_torch.utils.device import fold_seed, make_generator, resolve_device
from repro_torch.utils.logging import get_logger, log_kv

_log = get_logger("train")


def _fault_model(tc: TrainConfig, n_groups: int, n_pods: int):
    """FaultModel bound to the sync cascade, or None (faults off / not a
    replica mode).  Flat hier/local binds to the depth-1 tree whose single
    ``inter`` level fans every replica group into the server."""
    faults = getattr(tc.sync, "faults", None)
    if faults is None or not faults.enabled():
        return None
    if tc.sync.mode not in ("hier", "local"):
        return None
    from repro_torch.comm.topology import Link, get_topology
    from repro_torch.comm.tree import TreeLevel, TreeTopology, get_tree_topology
    from repro_torch.faults import FaultModel

    if tc.sync.mode == "hier" and tc.sync.levels:
        tree = get_tree_topology(tc.sync.topology)
    else:
        G = n_pods if tc.sync.mode == "hier" else n_groups
        try:
            link = get_topology(tc.sync.topology).inter
        except KeyError:
            link = Link(gbps=1.0, latency_us=1000.0)
        tree = TreeTopology(f"{tc.sync.topology}-flat",
                            (TreeLevel("inter", G, link),))
    return FaultModel(faults, tree)


def round_report(tc: TrainConfig, cfg: ModelConfig, device, log=print):
    """Log the per-round communication once; returns the RoundCost."""
    from repro_torch.core.distributed import round_comm

    cost = round_comm(tc.sync, cfg.param_count(), device=device)
    dense = 4.0 * cfg.param_count()
    stream = (f" streamed over {cost.tile_bytes >> 10} KB tiles "
              f"(serial {cost.serial_time_s * 1e3:.2f} ms, "
              f"{cost.stream_speedup:.2f}x)"
              if cost.tile_bytes else " (monolithic codec)")
    intra = (f" + {cost.intra_bytes / 1e6:.1f} MB intra-pod"
             if cost.intra_bytes else "")
    log(f"sync={tc.sync.mode}: {cost.inter_bytes / 1e6:.3f} MB/round on the slow "
        f"links ({dense / max(cost.inter_bytes, 1e-9):.1f}x vs dense fp32){intra}; "
        f"modelled {cost.time_s * 1e3:.2f} ms/round on the {tc.sync.topology} "
        f"preset,{stream}")
    for lv in cost.levels:
        log(f"  level {lv.name:<8s} fanout {lv.fanout:3d} period {lv.period:3d} "
            f"{lv.compressor:<10s} {lv.bytes_per_round / 1e6:.3f} MB/round  "
            f"modelled {lv.time_s * 1e3:.2f} ms/round")
    return cost


def _to_model_batch(batch: dict, device) -> dict:
    tokens = torch.as_tensor(batch["tokens"], device=device)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    for k, v in batch.items():
        if k != "tokens":
            out[k] = torch.as_tensor(v, device=device)
    return out


def train(cfg: ModelConfig, tc: TrainConfig, batches: Iterator[dict],
          n_groups: int = 1, n_pods: int = 1, steps: Optional[int] = None,
          ckpt_path: Optional[str] = None, log_every: int = 10, device=None,
          log: Callable[[str], None] = print, on_step=None):
    """Single-process training entry -> (state, history of per-step metric
    dicts of floats).  Weights are random from ``tc.seed``; the sync's draws
    come from a generator seeded from it too.  ``on_step(step, state,
    metrics)``, when given, sees every step's state (metrics still on the
    device), the only view of a state between the first and the last."""
    device = resolve_device(device)
    steps = steps or tc.total_steps
    params = init_params(tc.seed, cfg, device=device)
    gen = make_generator(fold_seed(tc.seed, 1), device)
    state = init_train_state(gen, params, tc, n_groups, n_pods)
    del params
    step_fn = make_train_step(cfg, tc, n_groups, n_pods)

    cost = None
    if tc.sync.mode != "dense":
        cost = round_report(tc, cfg, device, log)
        if obs_trace.enabled():
            registry.observe_round_cost(0, cost)
    fault_model = _fault_model(tc, n_groups, n_pods)
    fault_nbytes = None
    if fault_model is not None:
        log(f"fault injection on (seed={tc.sync.faults.seed}): degraded rounds "
            "aggregate over deadline survivors; replayable from (seed, round)")
        if cost is not None and len(cost.levels) == len(fault_model.tree.levels):
            # each level's nominal message from the measured round cost
            fault_nbytes = [lv.bytes_per_round * lv.period for lv in cost.levels]

    history = []
    t0 = obs_trace.wall_s()
    for step in range(steps):
        tracing = obs_trace.enabled()
        with obs_trace.span("round/step", round=step), obs_trace.step_annotation(step):
            model_batch = _to_model_batch(next(batches), device)
            masks = None
            if fault_model is not None:
                # dropped children sync with zero weight and keep their
                # local params this round
                plan = fault_model.round_plan(step, nbytes_by_level=fault_nbytes)
                masks = tuple(torch.as_tensor(m, device=device)
                              for m in plan.survivor_masks())
            state, metrics = step_fn(state, model_batch, masks)
        if fault_model is not None and tracing:
            registry.observe_fault_plan(step, plan)
        history.append(metrics)
        if on_step is not None:
            on_step(step, state, metrics)
        log_step = step % log_every == 0 or step == steps - 1
        if tracing or log_step:
            with obs_trace.span("round/blocking_fetch", round=step):
                fetched = {k: float(v) for k, v in metrics.items()}
            if tracing:
                registry.observe_train_step(step, fetched)
                log_kv(_log, "round", step=step, **fetched)
            if log_step:
                log(f"step {step:4d} loss {fetched['loss']:.4f} grad_norm "
                    f"{fetched['grad_norm']:.3f} ({obs_trace.wall_s() - t0:.2f}s)")
    # one transfer drains every step's still-on-device metrics
    keys = list(history[0]) if history else []
    table = torch.stack([torch.stack([h[k].float() for k in keys]) for h in history]).tolist() \
        if history else []
    history = [dict(zip(keys, row)) for row in table]
    if ckpt_path:
        save_checkpoint(ckpt_path, state.params, step=steps)
        log(f"saved checkpoint to {ckpt_path}")
    return state, history
