"""Training cells: the program's train step (``make_train_step`` on
``init_train_state``'s state) on weights and token rows made from the seed.

Set-up builds the one step and state, and drives them through the cell's
``checked_steps`` first steps (the warm-up: every shape the window uses)
through the same call and feed as the window.  After step 1 it reads the
gradient as the optimizer got it from Adam's first moment (``m / (1 -
b1)``), after the last the parameters' change from the seed's weights,
per leaf.  The window then runs steps until ``--seconds`` have
passed and the last step has finished on the device.

Once the window has closed and the program's state is freed, the plain
reference (``reference.train``) runs the same checked steps from the same
weights, rows and quantizer draws in f32, and the driver compares the
losses and the gradient's and the change's norms leaf by leaf.
"""
from __future__ import annotations

import contextlib
import gc
import math

import torch

from perf_bench.harness import bench, compare, spans
from perf_bench.harness import traffic as traffic_lib
from perf_bench.harness.devtrace import DeviceTrace
from perf_bench.harness.noise import RowNoise, tile_rows
from perf_bench.harness.weights import (by_path, check_program_tree, fold, leaf_specs,
                                        make_weights)
from perf_bench.reference import model as ref_model
from perf_bench.reference import train as ref_train


def n_groups(cell: dict) -> int:
    return cell["sync"].get("groups", 1) if cell["sync"]["mode"] != "dense" else 1


def noise_for(ctx, step: int, d: int):
    """Step ``step``'s quantizer draws, one ``RowNoise`` per group."""
    if ctx.cell["sync"]["mode"] != "efbv":
        return None
    return [RowNoise(ctx.device, tile_rows(d), ctx.seed, "sync", step, i)
            for i in range(n_groups(ctx.cell))]


def train_config(ctx, pcfg):
    from repro_torch.configs.base import SyncConfig, TrainConfig
    o, s, tr = ctx.cell["optimizer"], ctx.cell["sync"], ctx.traffic
    sync = SyncConfig(mode=s["mode"], compressor=s.get("compressor", "topk_block"),
                      quant_bits=s.get("quant_bits", 8))
    return TrainConfig(model=pcfg, seq_len=tr["seq_len"], global_batch=tr["global_batch"],
                       lr=o["lr"], weight_decay=o["weight_decay"],
                       warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                       optimizer=o["name"], grad_clip=o["grad_clip"], sync=sync,
                       remat=ctx.cell["remat"])


def tree_leaf_norms(tree, sl, fn=None) -> torch.Tensor:
    """f64 norms of a tree's leaves (``ref_train.leaves`` order), each of
    ``fn(path, flat leaf elements a..b, a, b)`` when given."""
    leaves = by_path(tree)
    out = []
    for path, _, n in sl:
        flat = leaves[path].reshape(-1)
        out.append(ref_train.chunked_norm(
            (lambda a, b, p=path, f=flat: fn(p, f[a:b], a, b)) if fn
            else (lambda a, b, f=flat: f[a:b]), n))
    return torch.stack(out).cpu()


def run(ctx: bench.Context) -> bench.Run:
    from repro_torch.models import init_params
    from repro_torch.training.steps import init_train_state, make_train_step

    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    pcfg = compare.program_config(cfg)
    specs = leaf_specs(cfg)
    check_program_tree(specs, init_params(0, pcfg, device="meta"))
    sl = ref_train.leaves(specs)
    d = sum(s.numel for s in specs)
    G, K = n_groups(cell), cell["checked_steps"]
    b1 = cell["optimizer"].get("b1", 0.9)
    vocab = cfg["vocab_size"]
    tr = ctx.traffic
    tokens_per_step = tr["seq_len"] * tr["global_batch"]
    cuda = torch.device(dev).type == "cuda"

    # ---------------------------------------------------------------- set-up
    spans.enable(ctx.trace and cuda)
    weights = make_weights(ctx.seed, cfg, dev)
    tc = train_config(ctx, pcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fold(ctx.seed, "state"))
    state = init_train_state(gen, weights.tree(), tc, G, 1)
    step = make_train_step(pcfg, tc, G, 1)
    prog_loss = []
    for t in range(1, K + 1):
        batch = traffic_lib.train_batch(ctx.seed, t, tr, vocab, dev)
        state, met = step(state, batch, noise=noise_for(ctx, t, d))
        prog_loss.append(float(met["loss"]))
        if t == 1:
            prog_grad = tree_leaf_norms(state.opt_state.mu, sl,
                                         lambda p, m, a, b: m.double() / (1 - b1))
    del weights, batch, met
    base = make_weights(ctx.seed, cfg, dev)
    prog_change = tree_leaf_norms(
        state.params, sl,
        lambda p, x, a, b: x.double() - base.leaf_at(p).reshape(-1)[a:b].double())
    del base
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)

    # ---------------------------------------------------------------- window
    spans.reset()
    trace_cm = DeviceTrace() if (ctx.trace and cuda) else contextlib.nullcontext()
    n, t = 0, K
    with trace_cm as dtrace:
        t0 = bench.now()
        setup_s = t0 - ctx.t0
        while True:
            t += 1
            batch = traffic_lib.train_batch(ctx.seed, t, tr, vocab, dev)
            state, met = step(state, batch, noise=noise_for(ctx, t, d))
            n += 1
            if bench.now() - t0 >= ctx.seconds:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = bench.now()
    last_loss = float(met["loss"])
    run = bench.Run(config=cfg, cell=cell, traffic=tr)
    run.window_s = t1 - t0
    run.attempted = n
    run.failed = 0 if math.isfinite(last_loss) else 1
    run.metrics = {"train_tokens_per_s": n * tokens_per_step / run.window_s,
                   "setup_s": setup_s}
    run.numbers = {"steps": n, "tokens_per_step": tokens_per_step, "last_loss": last_loss,
                   "d": d}
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if ctx.trace and cuda:
        run.spans, host = spans.collect()
        run.trace = dtrace
        run.series["host_spans"] = host
    spans.enable(False)
    del state, step, met, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- reference
    t_ref = bench.now()
    ref = reference(ctx, specs, sl, d, fp8=False)
    run.numbers["reference_s"] = bench.now() - t_ref
    keep = compare.moved(ref["grad"])
    gaps = numbers(prog_loss, prog_grad, prog_change, ref, keep)
    run.checks = [bench.limit_check(cell, k, gaps[k]) for k in cell["limits"]]
    run.numbers.update({k: v for k, v in gaps.items() if k not in cell["limits"]})
    run.numbers.update({"excluded_leaves": int((~keep).sum()),
                        "worst_grad": worst(sl, prog_grad, ref["grad"]),
                        "worst_change": worst(sl, prog_change, ref["change"], keep)})
    if ctx.control:
        ctl = reference(ctx, specs, sl, d, fp8=True)
        read = numbers(ctl["loss"], ctl["grad"], ctl["change"], ref, keep)
        run.control = [bench.limit_check(cell, k, read[k]) for k in cell["limits"]]
        run.numbers["control"] = read
    return run


def numbers(loss, grad, change, ref: dict, keep) -> dict:
    """Every number a training cell can compare; its ``limits`` name the
    ones it does: each step's loss, the first step's optimizer gradient and
    the change after the checked steps, leaf by leaf (the worst leaf, or
    the median leaf)."""
    return {"loss_gap": compare.loss_gap(loss, ref["loss"]),
            "grad_gap": compare.norm_gap(grad, ref["grad"]),
            "change_gap": compare.norm_gap(change, ref["change"], keep),
            "grad_gap_median": compare.median_gap(grad, ref["grad"]),
            "change_gap_median": compare.median_gap(change, ref["change"], keep)}


def worst(sl, prog, ref, keep=None, n: int = 3) -> list:
    """The leaves with the widest gaps: [path, program, reference]."""
    prog, ref = prog.double(), ref.double()
    k = torch.ones_like(ref, dtype=torch.bool) if keep is None else keep
    med = ref[k].median()
    gap = torch.where(k, (prog - ref).abs() / torch.maximum(ref, med), torch.zeros_like(ref))
    return [[sl[i][0], float(prog[i]), float(ref[i])]
            for i in gap.argsort(descending=True)[:n].tolist()]


def reference(ctx, specs, sl, d: int, fp8: bool) -> dict:
    """The checked steps in the plain reference: losses, the first step's
    optimizer gradient and the change after the last, per leaf."""
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    ref_model.exact_f32()
    w = make_weights(ctx.seed, cfg, dev)
    flat = w.flat_f32()
    del w
    sync = cell["sync"] if cell["sync"]["mode"] != "dense" else None
    tr = ref_train.Trainer(cfg, specs, flat, cell["optimizer"], sync, n_groups(cell), fp8=fp8)
    losses = []
    for t in range(1, cell["checked_steps"] + 1):
        batch = traffic_lib.train_batch(ctx.seed, t, ctx.traffic, cfg["vocab_size"], dev)
        noise = noise_for(ctx, t, d)
        out = tr.step(batch["tokens"], batch["targets"], noise=noise and (lambda i: noise[i]))
        losses.append(out["loss"])
        if t == 1:
            grad = ref_train.leaf_norms(tr.G, sl) * out["scale"]
    base = make_weights(ctx.seed, cfg, dev)
    change = torch.stack([ref_train.chunked_norm(
        lambda a, b, p=p, o=o: tr.P[o + a: o + b].double()
        - base.leaf_at(p).reshape(-1)[a:b].double(), k) for p, o, k in sl]).cpu()
    del tr, base, flat
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change}
