"""Multi-pod dry-run: trace every (arch x shape x mesh) step once, without
running it (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each step against ``ShapeDtypeStruct``
inputs under 512 forced host devices, then reads XLA's memory analysis,
cost analysis and collectives.  The port has no compiler between the
program and the card, so it runs the step itself, on nothing:

* the process owns a ``fake`` process group (``FakeStore``) of the
  production mesh's size, 256 or 512 ranks, and is rank 0 of it;
* every tensor is a fake tensor (``FakeTensorMode``): shapes, dtypes and
  allocations, no storage.  On a machine with a card they are fake
  ``cuda`` tensors; without one, fake ``cpu`` tensors (this build of
  torch cannot index a fake ``cuda`` tensor without CUDA).  Either way
  they stand for the card's tensors, so the kernel wrappers trace their
  kernel's registered fake, not the plain version;
* state, params and batch are DTensors with ``sharding.rules``'
  placements, the spec trees of the reference's ``build_*_lowering``;
  the hooks (gradient, activation, MoE) are installed as it installs them;
* the step runs once (forward, backward and update for train; ``prefill``
  or ``decode_step``) under ``MemTracker`` and ``CommDebugMode``.

A record holds rank 0's view: ``trace_s`` (the counterpart of the
reference's ``lower_s``; there is no ``compile_s``, as nothing compiles),
``memory`` in bytes (``argument_size_in_bytes``: the local shards of every
input; ``output_size_in_bytes``; ``peak_bytes`` from ``MemTracker``;
``temp_size_in_bytes`` = peak - arguments) and ``collectives``, counts by
kind.  ``host_state`` names the reference's int32 / key leaves that the
port keeps on the host (step counters, the PRNG key, the cache position),
with their bytes on the reference's devices.  Flops, bytes and the
collectives' payloads are the costing's (``launch.costing``,
``launch.hlo_analysis``).

MoE train (dense, hier) and prefill cells take the reference's
expert-parallel dispatch, ``models.moe.moe_ffn_shardmap`` (Queue 1, item
8d); ``set_moe_impl_override("alltoall")`` takes ``moe_ffn_alltoall`` and
``("scatter")`` the scatter dispatch, as in the reference.  efbv / local
and decode keep the scatter dispatch.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import (INPUT_SHAPES, SyncConfig, TrainConfig, get_config,
                                      list_configs)
from repro_torch.launch.specs import input_specs, skip_reason
from repro_torch.obs.trace import wall_s
from repro_torch.sharding import context as ctx
from repro_torch.sharding import layout, rules
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_flatten, tree_map

log = get_logger("dryrun")

def auto_grad_accum(cfg, shape, n_data: int, width_shards: int = 16) -> int:
    """Microbatch count so remat residuals + logits fit HBM: scale with the
    per-device token load and residual width."""
    local_batch = max(1, shape.global_batch // n_data)
    resid_gb = (cfg.num_layers * local_batch * shape.seq_len * cfg.d_model * 2
                / width_shards / 1e9)  # model-sharded bf16 stack
    accum = 1
    while resid_gb / accum > 1.0 and accum < local_batch:
        accum *= 2
    return accum


def _serving_fsdp(cfg, mesh):
    """FSDP params for serving only when tensor-parallel-only weights would
    not fit HBM (weight-gathered inference for the >60B archs)."""
    tp_bytes = cfg.param_count() * 2 / rules.mesh_sizes(mesh)["model"]
    return rules.data_axes(mesh) if tp_bytes > 8e9 else None


class Step(NamedTuple):
    """One traced cell: ``run()`` calls ``fn(*args)``, the step once on
    ``inputs`` (trees of DTensors laid out by the reference's
    ``in_shardings``, keyed by argument name; ``args`` holds them as the
    step takes them); ``host`` maps the reference's input leaves the port
    keeps on the host to their bytes there."""
    fn: Callable
    args: tuple
    inputs: dict
    host: dict

    def run(self):
        return self.fn(*self.args)


def fake_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def local_shape(shape, spec, mesh) -> tuple:
    """Rank 0's shard of a ``shape`` laid out by ``spec`` (the rules shard
    only dims that divide)."""
    sizes = rules.mesh_sizes(mesh)
    out = []
    for i, d in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            d //= sizes[a]
        out.append(d)
    return tuple(out)


def _distribute(meta, spec, mesh, device):
    """A DTensor of ``meta``'s shape and dtype laid out by ``spec`` (call
    under ``FakeTensorMode``: its local shard is a fake tensor)."""
    from torch.distributed.tensor import DTensor
    loc = torch.empty(local_shape(meta.shape, spec, mesh), dtype=meta.dtype, device=device)
    return DTensor.from_local(loc, mesh, rules.placements(spec, mesh), run_check=False,
                              shape=tuple(meta.shape),
                              stride=torch.empty(meta.shape, device="meta").stride())


def distribute_tree(metas, specs, mesh, device):
    return rules.map_with_specs(lambda m, s: _distribute(m, s, mesh, device), metas, specs)


def _dax(daxes):
    return daxes if len(daxes) > 1 else daxes[0]


def _meta_like(tree, dtype=None, lead=()):
    return tree_map(lambda p: torch.empty(tuple(lead) + tuple(p.shape),
                                          dtype=dtype or p.dtype, device="meta"), tree)


def train_specs(cfg, mesh, shape, sync_mode="dense", compressor="qsgd",
                sync_period=4, remat="full", grad_accum=None):
    """-> (TrainConfig, meta trees {"state": ..., "batch": ...}, spec trees of
    the same structure, host leaves): the reference's
    ``build_train_lowering`` spec trees (``dryrun.py:95-134``) for the
    port's state (params, AdamW moments, and per mode the sync state)."""
    from repro_torch.models import init_params
    from repro_torch.training.steps import _make_optimizer

    daxes = rules.data_axes(mesh)
    sizes = rules.mesh_sizes(mesh)
    n_groups = 1
    for a in daxes:
        n_groups *= sizes[a]
    n_pods = sizes.get("pod", 1)
    if grad_accum is None:
        if sync_mode != "dense":
            grad_accum = 1
        elif rules.NO_TP:
            grad_accum = auto_grad_accum(cfg, shape, n_groups * sizes["model"],
                                         width_shards=1)
        else:
            grad_accum = auto_grad_accum(cfg, shape, n_groups)
    tc = TrainConfig(model=cfg, seq_len=shape.seq_len, global_batch=shape.global_batch,
                     remat=remat, grad_accum=grad_accum,
                     sync=SyncConfig(mode=sync_mode, compressor=compressor,
                                     sync_period=sync_period))
    params = init_params(0, cfg, device="meta")
    dax = _dax(daxes)
    mode = sync_mode
    host = {"key": 8, "opt_state/step": 4}
    if mode in ("hier", "local"):
        G = n_pods if mode == "hier" else n_groups
        rep_ax = ("pod",) if mode == "hier" else dax
        fsdp = ("data",) if mode == "hier" else None
        params = _meta_like(params, lead=(G,))
        pspecs = rules.param_specs(
            params, mesh, extra_leading=2,
            replica_axes=rep_ax if not isinstance(rep_ax, tuple) or len(rep_ax) > 1
            else rep_ax[0], fsdp_axes=fsdp)
        host["opt_state/step"] = 4 * G       # vmap(opt.init): one per replica
    elif mode == "dense":
        fsdp_ax = daxes + ("model",) if rules.NO_TP else daxes
        pspecs = rules.param_specs(params, mesh, extra_leading=1, fsdp_axes=fsdp_ax)
    else:
        pspecs = rules.param_specs(params, mesh, extra_leading=1, fsdp_axes=daxes)
    opt_state = _make_optimizer(tc).init(params)
    state = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
    specs = {"params": pspecs, "mu": pspecs, "nu": pspecs}
    if mode in ("efbv", "ef21", "diana"):
        base = init_params(0, cfg, device="meta")
        state["h"] = _meta_like(base, torch.float32, lead=(n_groups,))
        state["h_bar"] = _meta_like(base, torch.float32)
        h_base = rules.param_specs(base, mesh, extra_leading=1)
        specs["h"] = rules.map_with_specs(lambda _, s: rules.spec(dax, *s), base, h_base)
        specs["h_bar"] = pspecs
        host["sync_state/step"] = 4
    elif mode in ("hier", "local"):
        base = init_params(0, cfg, device="meta")
        state["h_bar"] = _meta_like(base, torch.float32)
        specs["h_bar"] = rules.map_with_specs(lambda _, s: rules.spec(*tuple(s)[1:]),
                                              params, pspecs)
        host["sync_state/step"] = 4
    batch = input_specs(cfg, shape)
    metas = {"state": state, "batch": batch}
    specs = {"state": specs, "batch": rules.batch_specs(batch, mesh)}
    return tc, metas, specs, host, (n_groups, n_pods)


def _moe_impl(cfg, train_mode=None):
    """The reference's MoE dispatch choice (``dryrun.py:146-158``, ``:185``)
    for a train mode, or prefill with ``train_mode=None``."""
    if cfg.moe is None:
        return None
    impl = ("shardmap" if train_mode is None or train_mode in ("dense", "hier")
            else "scatter")
    return ctx.get_moe_impl_override() or impl


def _install_moe(cfg, mesh, impl):
    if impl is None:
        ctx.set_moe_specs(None)
        return
    ctx.set_moe_specs({"impl": impl, "mesh": mesh, "data_axes": rules.data_axes(mesh),
                       "gather_quant": ctx.get_moe_gather_quant(),
                       "tokens": (None, "model"), "expanded": (None, "model"),
                       "buf": ("model", None, None)})


def build_train_step(cfg, mesh, shape, sync_mode="dense", compressor="qsgd",
                     sync_period=4, remat="full", grad_accum=None, device=None) -> Step:
    """The counterpart of ``build_train_lowering``: the state and batch as
    DTensors and the step over ``mesh`` (call under ``FakeTensorMode``).
    hier / local are traced at a round where their sync fires (the state's
    step counter at ``sync_period - 1``): the round with the most traffic."""
    from repro_torch.core import distributed as cdist
    from repro_torch.optim.optimizers import OptState
    from repro_torch.training.steps import TrainState, make_train_step
    from repro_torch.utils.device import make_generator

    device = device or fake_device()
    tc, metas, specs, host, (n_groups, n_pods) = train_specs(
        cfg, mesh, shape, sync_mode, compressor, sync_period, remat, grad_accum)
    _install_moe(cfg, mesh, _moe_impl(cfg, sync_mode))
    daxes = rules.data_axes(mesh)
    dax = _dax(daxes)
    if sync_mode == "dense":
        ctx.set_grad_specs(specs["state"]["params"], mesh)
        act = ((daxes + ("model",), None, None) if rules.NO_TP else (dax, None, "model"))
        ctx.add_named_specs({"act": act}, mesh)
    else:
        ctx.set_grad_specs(None)
        # the per-rank steps run on the sub-mesh a group owns
        ctx.add_named_specs({"act": ("data", None, "model") if sync_mode == "hier"
                             else (None, None, "model")},
                            layout.sub_mesh(mesh, layout.group_axes(mesh, sync_mode)))
    inputs = {"state": distribute_tree(metas["state"], specs["state"], mesh, device),
              "batch": distribute_tree(metas["batch"], specs["batch"], mesh, device)}
    st = inputs["state"]
    sync_state = None
    if "h" in st:
        sync_state = cdist.SyncState(h=st["h"], h_bar=st["h_bar"], step=0)
    elif "h_bar" in st:
        sync_state = cdist.SyncState(h=(), h_bar=st["h_bar"], step=sync_period - 1)
    state = TrainState(st["params"], OptState(0, st["mu"], st["nu"]), sync_state,
                       make_generator(0, device))
    step = make_train_step(cfg, tc, n_groups, n_pods,
                           mesh=None if sync_mode == "dense" else mesh)
    return Step(step, (state, inputs["batch"]), inputs, host)


def build_prefill_step(cfg, mesh, shape, device=None) -> Step:
    """The counterpart of ``build_prefill_lowering`` (whose ``remat`` shapes
    only a backward pass, which a prefill runs none of)."""
    from repro_torch.models import init_params
    from repro_torch.training.steps import make_prefill_step

    device = device or fake_device()
    daxes = rules.data_axes(mesh)
    ctx.add_named_specs({"act": (_dax(daxes), None, "model")}, mesh)
    ctx.set_grad_specs(None)
    _install_moe(cfg, mesh, _moe_impl(cfg))
    params = init_params(0, cfg, device="meta")
    batch = input_specs(cfg, shape)
    specs = {"params": rules.param_specs(params, mesh, extra_leading=1,
                                         fsdp_axes=_serving_fsdp(cfg, mesh)),
             "batch": rules.batch_specs(batch, mesh)}
    inputs = {"params": distribute_tree(params, specs["params"], mesh, device),
              "batch": distribute_tree(batch, specs["batch"], mesh, device)}
    step = make_prefill_step(cfg)
    return Step(step, (inputs["params"], inputs["batch"]), inputs, {})


def build_decode_step(cfg, mesh, shape, device=None) -> Step:
    """The counterpart of ``build_decode_lowering``: one token against a
    ``shape.seq_len`` cache; MoE layers keep the scatter dispatch."""
    from repro_torch.models import init_params
    from repro_torch.training.steps import make_decode_step

    device = device or fake_device()
    ctx.set_named_specs(None)
    ctx.set_grad_specs(None)
    ctx.set_moe_specs(None)
    params = init_params(0, cfg, device="meta")
    specs_in = input_specs(cfg, shape)
    token, cache = specs_in["token"], specs_in["cache"]
    specs = {"params": rules.param_specs(params, mesh, extra_leading=1,
                                         fsdp_axes=_serving_fsdp(cfg, mesh)),
             "token": rules.batch_specs({"t": token}, mesh)["t"],
             "cache": rules.cache_pspecs(cache, mesh)}
    inputs = {"params": distribute_tree(params, specs["params"], mesh, device),
              "token": _distribute(token, specs["token"], mesh, device),
              "cache": distribute_tree(cache, specs["cache"], mesh, device)}
    step = make_decode_step(cfg)
    cache_in = dict(inputs["cache"], pos=shape.seq_len - 1)
    return Step(step, (inputs["params"], inputs["token"], cache_in), inputs,
                {"cache/pos": 4})


def build_single_step(cfg, shape, remat="full", device=None) -> Step:
    """One device, no mesh: a dense train step (no microbatches) or a
    prefill on plain tensors from ``torch.empty``; fake under
    ``FakeTensorMode`` (the estimate), real otherwise (the run it
    estimates: the memory anchor of ``chip_smoke.py``)."""
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import OptState
    from repro_torch.training.steps import (TrainState, _make_optimizer, make_prefill_step,
                                            make_train_step)
    from repro_torch.utils.device import make_generator

    device = device or fake_device()
    empty = lambda m: torch.empty(m.shape, dtype=m.dtype, device=device)  # noqa: E731
    params = tree_map(empty, init_params(0, cfg, device="meta"))
    batch = tree_map(empty, input_specs(cfg, shape))
    if shape.kind == "prefill":
        step = make_prefill_step(cfg)
        return Step(step, (params, batch), {"params": params, "batch": batch}, {})
    tc = TrainConfig(model=cfg, seq_len=shape.seq_len, global_batch=shape.global_batch,
                     remat=remat, grad_accum=1, sync=SyncConfig(mode="dense"))
    meta_opt = _make_optimizer(tc).init(init_params(0, cfg, device="meta"))
    opt = OptState(0, tree_map(empty, meta_opt.mu), tree_map(empty, meta_opt.nu))
    state = TrainState(params, opt, None, make_generator(0, device))
    step = make_train_step(cfg, tc, 1, 1)
    return Step(step, (state, batch),
                {"state": {"params": params, "mu": opt.mu, "nu": opt.nu}, "batch": batch},
                {"key": 8, "opt_state/step": 4})


def local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (each storage
    once)."""
    seen, total = set(), 0
    for t in local_tensors(tree):
        key = (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


class _Propagation:
    """Counts how deep this thread is in DTensor's sharding propagation,
    which derives an op's output metadata by running it on global-shape
    fake tensors: no rank's memory."""
    depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


_PROPAGATING = _Propagation()
# the ShardingPropagator methods that run ops for metadata (by torch version)
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _marking_propagation(fn):
    def wrapper(*args, **kwargs):
        with _PROPAGATING:
            return fn(*args, **kwargs)
    return wrapper


def _active_fake_mode():
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def _local_mem_tracker(mode):
    """A ``MemTracker`` of the ops run under the dry-run's fake ``mode``
    (``None``: a real run, under no fake mode) and outside DTensor's
    sharding propagation, which may run its ops under a fake mode of its
    own or reuse the active one, depending on torch's version."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _PROPAGATING.depth or _active_fake_mode() is not mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def trace_step(build: Callable, fake: bool = True, cost: bool = False) -> dict:
    """Build and run one step under ``FakeTensorMode``, ``MemTracker`` and
    ``CommDebugMode`` -> the record's ``trace_s``, ``memory`` and
    ``collectives``.  ``fake=False`` runs the same on the real tensors
    ``build`` makes (the check of the fake estimate).  ``cost=True`` traces
    under ``hlo_analysis.CostCounter``'s fake mode and adds ``cost`` (flops
    and the unfused bytes bound of rank 0's local ops) and
    ``collective_stats`` (their payloads by kind)."""
    from contextlib import nullcontext

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.hlo_analysis import CostCounter

    t0 = wall_s()
    named = ctx.named_specs_state()       # a perf variant's, kept across traces
    saved = {n: ShardingPropagator.__dict__[n] for n in _PROPAGATORS
             if n in ShardingPropagator.__dict__}
    for n, fn in saved.items():
        setattr(ShardingPropagator, n, _marking_propagation(fn))
    counter = CostCounter(paused=lambda: _PROPAGATING.depth > 0) if cost else None
    if not fake:
        fake_mode = nullcontext()
    elif cost:
        fake_mode = counter.mode(allow_non_fake_inputs=True)
    else:
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        with fake_mode as mode:
            step = build()
            args = nbytes(step.inputs)
            mt = _local_mem_tracker(mode)
            mt.track_external(*local_tensors(step.inputs))
            with mt, CommDebugMode() as comm, implicit_replication():
                out = step.run()
            peak = max(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
            counts = {str(k).split(".")[-1]: int(v)
                      for k, v in comm.get_comm_counts().items() if v}
            out_bytes = nbytes(out)
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)
        ctx.set_grad_specs(None)
        ctx.restore_named_specs(named)
        ctx.set_moe_specs(None)
    rec = {"trace_s": round(wall_s() - t0, 2),
           "memory": {"argument_size_in_bytes": args, "output_size_in_bytes": out_bytes,
                      "peak_bytes": int(peak), "temp_size_in_bytes": int(peak) - args},
           "collectives": counts, "spec_host": step.host}
    if cost:
        rec.update(cost=counter.cost_dict(), collective_stats=counter.stats.as_dict())
    return rec


def init_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``world``
    ranks: kept when one of that size exists, replaced when a fake group of
    another size does; any other group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group exists; the dry-run "
                               "owns its process's group")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_one(arch: str, shape_name: str, multi_pod: bool, sync_mode: str = "dense",
            compressor: str = "qsgd", remat: str = "full", mesh=None, cfg=None,
            shape=None) -> dict:
    """One cell -> its record.  ``mesh``, ``cfg`` and ``shape`` override the
    production mesh (made on the current fake group), ``get_config(arch)``
    and ``INPUT_SHAPES[shape_name]`` (the tests' reduced cells)."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "sync": sync_mode}
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    if mesh is None:
        init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=fake_device())
    rec["mesh"] = "x".join(str(n) for n in mesh.shape)
    rec["fake_device"] = fake_device()
    if shape.kind == "train":
        build = lambda: build_train_step(cfg, mesh, shape, sync_mode, compressor,  # noqa: E731
                                         remat=remat)
    elif shape.kind == "prefill":
        build = lambda: build_prefill_step(cfg, mesh, shape)  # noqa: E731
    else:
        build = lambda: build_decode_step(cfg, mesh, shape)  # noqa: E731
    try:
        got = trace_step(build)
    except Exception as e:  # noqa: BLE001 -- record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    rec["host_state"] = got.pop("spec_host")
    rec.update(got, status="ok")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--sync", default="dense",
                    choices=["dense", "efbv", "ef21", "diana", "hier", "local"])
    ap.add_argument("--compressor", default="qsgd")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for mp in pods:     # one fake group per mesh size: the outer loop
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}__{args.sync}"
                log.info("dry-run %s", tag)
                rec = run_one(arch, shape, mp, args.sync, args.compressor, args.remat)
                results.append(rec)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
                log.info("  -> %s (trace %.1fs)", rec["status"], rec.get("trace_s", 0))
                if rec["status"] == "ok":
                    log.info("  memory %s collectives %s", rec["memory"], rec["collectives"])
                elif rec["status"] != "skipped":
                    log.info("  %s", rec.get("error") or rec.get("reason"))
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    log.info("done: %d ok, %d skipped, %d other of %d", ok, sk, len(results) - ok - sk,
             len(results))
    return results


if __name__ == "__main__":
    main()
