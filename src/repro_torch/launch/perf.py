"""Perf variants of a dry-run cell (port of ``repro/launch/perf.py``): trace an
(arch, shape) pair under named variants on the production mesh and report
the extrapolated roofline terms and the memory against the baseline.

Variants (composable as a comma list):
  banded      banded flash attention: SWA / chunked layers skip masked KV
              blocks (``attention.BANDED``)
  ssd_heads   SSD heads sharded over "model" inside the mamba blocks (the
              ``ssd_x`` and ``ssd_dt`` named specs)
  sync_hier   pod-level hier sync (dense inside a pod, EF21-compressed
              across pods every ``sync_period`` steps)
  sync_efbv   EF-BV compressed gradient sync over the data axes
  moe_quant   int8 token gather + bf16 psum in the shardmap MoE
              (``set_moe_gather_quant(True)``)
  moe_a2a     all-to-all expert dispatch (``set_moe_impl_override("alltoall")``)
  no_tp       pure FSDP, no tensor parallelism (``rules.NO_TP``)
  accum2x     twice the automatic microbatch count

What the port reads in place of XLA's artifacts: ``measure`` runs on the
``fake`` process group, as ``dryrun.main`` does (nothing allocated, nothing
compiled).  The memory comes from the dry-run's trace of the whole step,
the costs from ``costing.corrected_costs`` (1 and 2 layer periods under
``hlo_analysis.CostCounter``).  This measures no card time: the terms are
those costs over the NVIDIA H100's peak rates (``launch.mesh``), a roofline
model.  ``trace_s`` (the reference's ``compile_s``) is host seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch h2o-danube-1.8b \\
      --shape prefill_32k --variants banded
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# one 400 Gb/s NDR InfiniBand port per GPU between nodes (NVIDIA DGX H100:
# eight ConnectX-7 400 Gb/s ports for eight GPUs): the inter-pod links
INTER_NODE_BW = 400e9 / 8       # bytes/s per device

VARIANTS = ("banded", "ssd_heads", "sync_hier", "sync_efbv", "moe_quant", "moe_a2a",
            "no_tp", "accum2x")


def apply_variants(variants, mesh, cfg):
    """Set the variants' flags -> (sync mode, extra {"accum_mult": 2})."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.sharding import context as ctx
    from repro_torch.sharding import rules

    daxes = rules.data_axes(mesh)
    dax = daxes if len(daxes) > 1 else daxes[0]
    sync = "dense"
    extra = {}
    if "banded" in variants:
        attn_lib.BANDED = True
    if "ssd_heads" in variants and cfg.mamba is not None:
        ctx.set_named_specs({"ssd_x": (dax, None, "model", None),
                             "ssd_dt": (dax, None, "model")}, mesh)
    if "no_tp" in variants:
        rules.NO_TP = True
    if "moe_a2a" in variants:
        ctx.set_moe_impl_override("alltoall")
    if "moe_quant" in variants:
        ctx.set_moe_gather_quant(True)
    if "sync_hier" in variants:
        sync = "hier"
    if "sync_efbv" in variants:
        sync = "efbv"
    if "accum2x" in variants:
        extra["accum_mult"] = 2
    return sync, extra


def reset_variants():
    from repro_torch.models import attention as attn_lib
    from repro_torch.sharding import context as ctx
    from repro_torch.sharding import rules

    attn_lib.BANDED = False
    ctx.set_named_specs(None)
    ctx.set_moe_gather_quant(False)
    rules.NO_TP = False
    ctx.set_moe_impl_override(None)


def measure(arch, shape_name, variants, multi_pod=False, cfg=None):
    """One perf record; ``cfg`` overrides ``get_config(arch)`` (a reduced
    config's record)."""
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch.costing import corrected_costs, model_flops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.obs import trace as obs_trace

    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    dr.init_fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dr.fake_device())
    sync, extra = apply_variants(variants, mesh, cfg)
    try:
        # the whole step's trace -> the memory (each phase an obs span when
        # tracing is on, so a traced hill-climb shows where host time goes)
        t0 = obs_trace.wall_s()
        with obs_trace.span("perf/trace", arch=arch, shape=shape_name, sync=sync):
            if shape.kind == "train":
                ga = None
                if extra.get("accum_mult"):
                    ga = dr.auto_grad_accum(cfg, shape, 32 if multi_pod else 16) \
                        * extra["accum_mult"]
                build = lambda: dr.build_train_step(cfg, mesh, shape, sync,   # noqa: E731
                                                    grad_accum=ga)
            elif shape.kind == "prefill":
                build = lambda: dr.build_prefill_step(cfg, mesh, shape)       # noqa: E731
            else:
                build = lambda: dr.build_decode_step(cfg, mesh, shape)        # noqa: E731
            rec = dr.trace_step(build)
        with obs_trace.span("perf/memory"):
            mem = hlo.memory_dict(rec)
        # the costs (the variant flags stay set inside)
        with obs_trace.span("perf/corrected_costs"):
            cc = corrected_costs(cfg, mesh, shape_name, sync_mode=sync)
        c = cc["corrected"]
        terms = {
            "compute_s": c.get("flops", 0.0) / PEAK_FLOPS_BF16,
            "memory_s": c.get("bytes", 0.0) / HBM_BW,
            "collective_s": c.get("coll_total", 0.0) / NVLINK_BW,
            "interpod_s": c.get("coll_interpod", 0.0) / INTER_NODE_BW,
        }
        mf = model_flops(cfg, shape_name)["model_flops"]
        return {
            "arch": arch, "shape": shape_name, "variants": variants,
            "sync": sync, "mesh": "2x16x16" if multi_pod else "16x16",
            "terms_s": terms,
            "dominant": max((k for k in terms if k != "interpod_s"), key=lambda k: terms[k]),
            "useful_ratio": mf / (c.get("flops", 1) * n_chips),
            "mem_gb": {k: v / 1e9 for k, v in mem.items() if "size" in k},
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
            "trace_s": round(obs_trace.wall_s() - t0, 1),
            **{k: v for k, v in c.items() if k.startswith("coll_")},
        }
    finally:
        reset_variants()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="", help="comma list; empty = baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known {list(VARIANTS)}")
    from repro_torch.obs import trace as obs_trace

    rec = measure(args.arch, args.shape, variants, args.multi_pod)
    if obs_trace.enabled():
        # every perf row carries its trace file (REPRO_TRACE=1)
        obs_trace.set_meta(label=f"perf_{args.arch}_{args.shape}",
                           variants=",".join(variants))
        rec["trace"] = obs_trace.export_jsonl(f"TRACE_perf_{args.arch}_{args.shape}.jsonl")
    print(json.dumps(rec, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return rec


if __name__ == "__main__":
    main()
