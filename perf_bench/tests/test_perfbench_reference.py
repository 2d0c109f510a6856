"""The plain references held to the program at reduced sizes on the CPU:
the two architectures' logits, the qsgd quantizer, one EF-BV step and one
AdamW step.  This file imports both the reference and the program; the
reference itself imports nothing of the program."""
from __future__ import annotations

import pytest
import torch

from perf_bench.harness import bench, compare
from perf_bench.harness import traffic
from perf_bench.harness.noise import RowNoise
from perf_bench.harness.weights import check_program_tree, leaf_specs, make_weights
from perf_bench.reference import model as ref_model
from perf_bench.reference import train as ref_train
from perf_bench.tests import small


@pytest.mark.parametrize("name,S", [("h2o-danube-1.8b", 40), ("mamba2-2.7b", 21)])
def test_logits_equal_the_program(name, S):
    from repro_torch.models import forward_train, init_params
    cfg = small.reduced_config(name)
    pcfg = compare.program_config(cfg)
    specs = leaf_specs(cfg)
    check_program_tree(specs, init_params(0, pcfg, device="meta"))
    w = make_weights(small.SEED, cfg, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, S), generator=torch.Generator().manual_seed(1))
    prog, _ = forward_train(w.tree(), pcfg, {"tokens": tokens}, remat="none")
    params = ref_train.param_views(w.flat_f32(), specs)
    ref = ref_model.logits(params, cfg, ref_model.hidden(params, cfg, tokens))
    torch.testing.assert_close(prog[..., : cfg["vocab_size"]], ref, atol=2e-5, rtol=1e-4)


def test_qsgd_equals_the_program_quantizer():
    from repro_torch.core.compressors import make_compressor
    d = 3 * 4096 + 700
    x = torch.randn(d, generator=torch.Generator().manual_seed(2))
    x[512:1024] = 0.0                       # an all-zero row keeps scale 1
    noise = RowNoise("cpu", -(-d // 4096) * 8, small.SEED, "test")
    prog = make_compressor("qsgd_kernel", bits=8)(x.clone(), noise=noise.materialize())
    ref = ref_train.qsgd_(x.clone(), noise, 8)
    # the program multiplies by an f32 reciprocal of s, the reference divides
    step = x.view(-1)[: d // 512 * 512].view(-1, 512).abs().amax(1).max() / 127
    assert float((prog - ref).abs().max()) <= float(step) * 1.0001
    assert float((prog != ref).float().mean()) < 1e-3


@pytest.mark.parametrize("cell", ["danube-train-efbv", "mamba2-train-dense"])
def test_one_train_step_equals_the_program(cell):
    """One step of the program (EF-BV + qsgd with the benchmark's draws,
    or the dense mean) and its AdamW update against the reference's: the
    loss, the parameters after the update and EF-BV's control variates."""
    from repro_torch.training.steps import init_train_state, make_train_step
    drv = bench.load_py("drivers", "train")
    ctx = small.context(cell, layers=2)
    cfg = ctx.config
    pcfg = compare.program_config(cfg)
    specs = leaf_specs(cfg)
    d = sum(s.numel for s in specs)
    G = drv.n_groups(ctx.cell)
    w = make_weights(ctx.seed, cfg, "cpu")
    state = init_train_state(torch.Generator().manual_seed(0), w.tree(),
                             drv.train_config(ctx, pcfg), G, 1)
    step = make_train_step(pcfg, drv.train_config(ctx, pcfg), G, 1)
    batch = traffic.train_batch(ctx.seed, 1, ctx.traffic, cfg["vocab_size"], "cpu")
    noise = drv.noise_for(ctx, 1, d)
    state, met = step(state, batch, noise=noise)
    sync = ctx.cell["sync"] if ctx.cell["sync"]["mode"] != "dense" else None
    ref = ref_train.Trainer(cfg, specs, make_weights(ctx.seed, cfg, "cpu").flat_f32(),
                            ctx.cell["optimizer"], sync, G)
    out = ref.step(batch["tokens"], batch["targets"], noise=noise and (lambda i: noise[i]))
    assert abs(float(met["loss"]) - out["loss"]) < 1e-5
    # Adam's first update is lr * g / (|g| + eps): where g is near 0 the two
    # sides' rounding moves an element by a fraction of lr
    diff = (w.flat_f32() - ref.P).abs()
    assert float(diff.max()) < 0.1 * ctx.cell["optimizer"]["lr"]
    assert float((diff > 1e-6).float().mean()) < 1e-4
    if sync:
        # a gradient that differs in its last bits, or the scale's
        # reciprocal multiply against a division, can put an element on the
        # next quantization level (a step is a row's max / 127)
        h = state.sync_state.h.reshape(G, -1)[:, :d]
        pairs = [(h[i], ref.h[i]) for i in range(G)]
        pairs.append((state.sync_state.h_bar.reshape(-1)[:d], ref.hbar))
        for a, b in pairs:
            diff = (a - b).abs()
            assert float(diff.max()) <= 0.01 * float(b.abs().max())
            assert float((diff > 1e-6).float().mean()) < 1e-3


def test_param_views_take_the_gradient_in_place():
    """Each leaf's gradient accumulates into its view of the flat gradient
    buffer, with no second copy of the gradient."""
    cfg = small.reduced_config("mamba2-2.7b")
    specs = leaf_specs(cfg)
    flat = make_weights(small.SEED, cfg, "cpu").flat_f32()
    grad = torch.zeros_like(flat)
    params = ref_train.param_views(flat, specs, grad)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 16),
                           generator=torch.Generator().manual_seed(3))
    ref_model.loss(params, cfg, tokens, tokens).backward()
    lo, hi = grad.data_ptr(), grad.data_ptr() + grad.numel() * grad.element_size()
    for v in params.values():
        for t in v if isinstance(v, list) else [v]:
            assert lo <= t.grad.data_ptr() < hi
    assert float(grad.abs().sum()) > 0
