"""Layer-period extrapolation of the traced costs (port of
``repro/launch/costing.py``).

The reference lowers a step with 1 and 2 layer periods (A, B) because XLA's
cost analysis counts a while-loop body once; it solves
``per_period = B - A``, ``const = A - per_period`` and
``corrected = const + n_periods * per_period``, and a third lowering (C,
``block_k`` doubled) gives the flash attention's q x kv loops their trip
counts through an ``alpha * (Sq * Sk - bq * b0)`` term.

The port's costs come from ``launch.hlo_analysis.CostCounter`` over the
dry-run's trace (``dryrun.trace_step(..., cost=True)``), which reads no
compiled artifact:

* A and B are traced with 1 and 2 layer periods at the model's own tile
  sizes.  The trace runs every Python tile of ``_flash_attention`` (and
  every chunk of the SSD scan), so A and B already hold the whole
  attention: there is no loop body counted once, C is ``None`` and
  ``detail`` is empty.  ``mean_span`` (each attention instance's kv reach)
  is kept for the record, computed as the reference computes it.
* The period extrapolation is what saves host time: two traces of 1 and 2
  periods instead of one of every layer.  Costs are affine in the period
  count, so the extrapolation is exact for collective bytes; flops too,
  up to float rounding.
* Train steps are traced at ``grad_accum=1`` (totals do not depend on the
  microbatching), as the reference lowers them.
* ``mesh=None`` traces the one-device step of ``dryrun.build_single_step``
  (a dense train step or a prefill), the step ``chip_smoke.py``'s flop
  anchor runs on the card.

``comm_time_model`` and ``model_flops`` are the reference's arithmetic over
the port's ``comm.topology`` / ``comm.tree`` copies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.comm.topology import DEFAULT_TILE_BYTES as _STREAM_TILE
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models import attention as attn_lib
from repro_torch.models.transformer import period_info

B0_K = 512
B0_Q = 512


def _measures(rec: dict) -> Dict[str, float]:
    """A traced record's costs under the reference's measure keys."""
    cost = hlo.cost_dict(rec)
    colls = rec["collective_stats"]
    out = {"flops": cost["flops"], "bytes": cost["bytes unfused"],
           "coll_total": colls["total_bytes"], "coll_interpod": colls["inter_pod_bytes"]}
    for k, v in colls["by_kind"].items():
        out[f"coll_{k}"] = v
    return out


def _trace_variant(cfg, mesh, shape, n_periods: int, sync_mode: str,
                   device=None) -> Dict[str, float]:
    """The costs of ``cfg`` cut to ``n_periods`` layer periods."""
    from repro_torch.launch import dryrun as dr

    P = period_info(cfg)[0]
    vcfg = dataclasses.replace(cfg, num_layers=P * n_periods,
                               enc_layers=(n_periods if cfg.enc_layers else 0))
    if mesh is None:
        build = lambda: dr.build_single_step(vcfg, shape, device=device)      # noqa: E731
    elif shape.kind == "train":
        build = lambda: dr.build_train_step(vcfg, mesh, shape, sync_mode,     # noqa: E731
                                            grad_accum=1, device=device)
    elif shape.kind == "prefill":
        build = lambda: dr.build_prefill_step(vcfg, mesh, shape, device=device)  # noqa: E731
    else:
        build = lambda: dr.build_decode_step(vcfg, mesh, shape, device=device)   # noqa: E731
    return _measures(dr.trace_step(build, cost=True))


def corrected_costs(arch_cfg: ModelConfig, mesh, shape_name, sync_mode: str = "dense",
                    grad_accum: int = 1, device=None) -> Dict:
    """Returns {'corrected': {...}, 'variants': {'A', 'B', 'C'}, 'n_periods',
    'grad_accum', 'mean_span', 'detail', 'comm_time'}, the reference's
    keys.  ``shape_name`` is a name of ``INPUT_SHAPES`` or an
    ``InputShape``; ``mesh`` a production mesh on the current fake group,
    or ``None`` for one device."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    P, n_periods, pos_kinds, _ = period_info(arch_cfg)

    A = _trace_variant(arch_cfg, mesh, shape, 1, sync_mode, device)
    B = _trace_variant(arch_cfg, mesh, shape, 2, sync_mode, device)

    Sk = shape.seq_len
    # each attention instance's kv reach in one period: the banded flash
    # variant (attn_lib.BANDED) visits only the window's / chunk's blocks
    spans = []
    for kind in pos_kinds:
        if not kind.startswith("attn"):
            continue
        if attn_lib.BANDED and kind == "attn_swa":
            spans.append(min(Sk, arch_cfg.sliding_window + B0_K))
        elif attn_lib.BANDED and kind == "attn_chunk":
            spans.append(min(Sk, arch_cfg.attn_chunk + B0_K))
        else:
            spans.append(Sk)
    if arch_cfg.enc_layers:
        spans.extend([Sk, Sk])  # encoder self-attn + cross-attn per unit
    mean_span = (sum(spans) / len(spans)) if spans else Sk

    corrected = {}
    for key in A:
        a, b = A[key], B.get(key, 0.0)
        per_period = b - a
        const = a - per_period
        corrected[key] = max(const + n_periods * per_period, a)
    return {"corrected": corrected, "variants": {"A": A, "B": B, "C": None},
            "n_periods": n_periods, "grad_accum": grad_accum,
            "mean_span": mean_span, "detail": {},
            "comm_time": comm_time_model(corrected, tile_bytes=_STREAM_TILE)}


def comm_time_model(measures: Dict[str, float], topology=None,
                    tile_bytes: int = 0, faults=None) -> Dict[str, float]:
    """Bandwidth-bound collective wall-clock from the corrected per-device
    bytes, split onto a topology preset's links (the reference's arithmetic,
    ``costing.py:133-208``): the inter-pod share rides the slow links, the
    rest the intra-pod fabric.  A ``comm.tree.TreeTopology`` reports one
    ``t_<level>_s`` term per level; ``tile_bytes > 0`` adds the pipelined
    ``t_comm_stream_s``; an enabled ``FaultConfig`` adds
    ``t_comm_degraded_s``.  A model of the preset's links, not a time
    measured on any device."""
    from repro_torch.comm.topology import get_topology, pipelined_time_s
    from repro_torch.comm.tree import TreeTopology

    topo = topology or get_topology("v5p_superpod")
    total = float(measures.get("coll_total", 0.0))
    inter = float(measures.get("coll_interpod", 0.0))
    intra = max(0.0, total - inter)
    if isinstance(topo, TreeTopology):
        t_intra = intra / (topo.levels[0].link.gbps * 1e9)
        stages = [t_intra]
        out = {"intra_bytes": intra, "inter_bytes": inter,
               f"t_{topo.levels[0].name}_s": t_intra, "topology": topo.name}
        for lev in topo.levels[1:]:
            t = inter / (lev.link.gbps * 1e9)
            out[f"t_{lev.name}_s"] = t
            stages.append(t)
        out["t_comm_s"] = sum(stages)
    else:
        t_intra = intra / (topo.intra.gbps * 1e9)
        t_inter = inter / (topo.inter.gbps * 1e9)
        stages = [t_intra, t_inter]
        out = {"intra_bytes": intra, "inter_bytes": inter,
               "t_intra_s": t_intra, "t_inter_s": t_inter,
               "t_comm_s": t_intra + t_inter, "topology": topo.name}
    if tile_bytes > 0:
        n_tiles = max(1, -(-int(total) // int(tile_bytes)))
        out["t_comm_stream_s"] = pipelined_time_s(tuple(stages), n_tiles)
        out["stream_tile_bytes"] = int(tile_bytes)
    if faults is not None and faults.enabled():
        from repro_torch.comm.topology import straggler_level_time_s

        if isinstance(topo, TreeTopology):
            hops = [(lev.name, topo.level_faults(l, faults), topo.n_children(l), t)
                    for l, (lev, t) in enumerate(zip(topo.levels, stages))]
        else:
            hops = [("intra", faults.link_faults("intra"), topo.devices_per_pod, stages[0]),
                    ("inter", faults.link_faults("inter"), topo.n_pods, stages[1])]
        degraded = 0.0
        for name, lf, n, t in hops:
            e_tx = faults.expected_transmissions(lf.loss_rate)
            base = (t * e_tx + faults.backoff_s * (e_tx - 1.0)
                    + lf.delay_rate * lf.delay_s)
            degraded += straggler_level_time_s(
                base, faults.straggler_rate, faults.straggler_sigma, n,
                faults.level_deadline_s(name))
        out["t_comm_degraded_s"] = degraded
    return out


def model_flops(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    """MODEL_FLOPS: 6*N*D for training (N = active params), 2*N per token for
    decode, 2*N*D for prefill: the 'useful work' yardstick."""
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return {"model_flops": 6.0 * n_active * tokens}
    if shape.kind == "prefill":
        return {"model_flops": 2.0 * n_active * tokens}
    return {"model_flops": 2.0 * n_active * shape.global_batch}
