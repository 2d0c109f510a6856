"""granite-4.0-h-small, the port's own architecture, against the
benchmark's plain f32 reference (``perf_bench/families/hybrid.py``) on the
CPU: one whole period (nine Mamba2 layers and a NoPE attention layer, each
a dropless MoE over a held share of 8 of the router's 72 experts, top 10,
and a shared expert) at small widths, in f32, on seeded random weights.

The logits, the loss and every leaf's gradient of a training forward with
remat; prefill then decode through the cache against the reference's
forward over the whole sequence; the nine shares of an expert layer
summing to the uncut layer; nothing dropped when every token picks one
expert; danube's and mamba2's logits untouched by the new fields'
defaults; the expert layer's spans and its tally.  About 20 s alone.
"""
import math
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.utils.tree import tree_flatten, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perf_bench.harness import bench, compare  # noqa: E402
from perf_bench.harness.weights import by_path, check_program_tree, leaf_specs  # noqa: E402
from perf_bench.harness.weights import make_weights  # noqa: E402
from perf_bench.reference import model as ref_model  # noqa: E402
from perf_bench.reference import train as ref_train  # noqa: E402
from perf_bench.tests import small  # noqa: E402

torch.set_num_threads(2)
NAME = "granite-4.0-h-small"
HYBRID = bench.load_py("families", "hybrid")
# f32 on both sides: the SSD's chunk loop against the paper's listing, the
# tiled attention against one softmax, grouped expert products against
# dense ones sum in other orders; a few ulps of f32 through ten layers
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _clean_obs_state():
    obs_trace.disable()
    obs_trace.get_tracer().reset()
    yield
    obs_trace.disable()
    obs_trace.get_tracer().reset()


def _setup(seed: int = small.SEED):
    """(benchmark config at test sizes, the program's config, the weights
    as the program's tree, the reference's per-layer views of them)."""
    cfg = small.reduced_config(NAME, layers=None)
    pcfg = compare.program_config(cfg)
    specs = leaf_specs(cfg)
    check_program_tree(specs, tm.init_params(0, pcfg, device="meta"))
    w = make_weights(seed, cfg, "cpu")
    return cfg, pcfg, w.tree(), ref_train.param_views(w.flat_f32(), specs), specs


def _tokens(cfg, shape, seed=1):
    return torch.randint(0, cfg["vocab_size"], shape, generator=torch.Generator().manual_seed(seed))


def test_the_registered_model_at_published_widths():
    cfg = get_config(NAME)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == \
        (40, 4096, 32, 8, 128)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_ff, cfg.moe.shared_d_ff) == (72, 10, 768, 1536)
    assert cfg.layer_kinds().count("attn") == 4 and cfg.layer_kinds()[5] == "attn"
    assert (cfg.mamba.d_state, cfg.mamba.head_dim, cfg.mamba.expand) == (128, 64, 2)
    # the leaves: 32,207,337,984; ``param_count`` follows the JAX package's
    # formula, which leaves out each Mamba layer's conv bias and D (8,576)
    leaves = sum(t.numel() for t in tree_flatten(tm.init_params(0, cfg, device="meta"))[0])
    assert leaves == 32_207_337_984
    assert cfg.param_count() == leaves - 36 * 8_576
    # the benchmark's share: one period, 8 experts, 1/8 of the vocabulary
    share = replace(cfg, num_layers=10, vocab_size=12_544, moe=replace(cfg.moe, held=8))
    leaves = sum(t.numel() for t in tree_flatten(tm.init_params(0, share, device="meta"))[0])
    assert leaves == 1_960_659_584 == sum(s.numel for s in leaf_specs(bench.load_json("configs", NAME)))


def test_logits_loss_and_gradients_equal_the_reference():
    cfg, pcfg, tree, params, specs = _setup()
    tokens, targets = _tokens(cfg, (2, 21)), _tokens(cfg, (2, 21), seed=2)
    leaves, td = tree_flatten(tree)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    prog = tree_unflatten(td, req)
    lg, _ = tm.forward_train(prog, pcfg, {"tokens": tokens}, remat="dots")
    loss, parts = tm.loss_fn(prog, pcfg, {"tokens": tokens, "targets": targets}, remat="dots")
    grads = torch.autograd.grad(loss, req)

    flat = make_weights(small.SEED, cfg, "cpu").flat_f32()
    gbuf = torch.zeros_like(flat)
    rp = ref_train.param_views(flat, specs, gbuf)
    ref_lg = ref_model.logits(rp, cfg, ref_model.hidden(rp, cfg, tokens))
    torch.testing.assert_close(lg[..., : cfg["vocab_size"]], ref_lg.detach(), rtol=RTOL, atol=ATOL)
    ref_loss = ref_model.loss(rp, cfg, tokens, targets, remat=True)
    ref_loss.backward()
    # the load-balance weight is 0: the loss is the cross-entropy alone
    assert float(parts["aux"].detach()) > 0
    assert float(loss.detach()) == float(parts["ce"].detach())
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= 1e-6 * float(ref_loss.detach())
    got = by_path(tree_unflatten(td, list(grads)))
    o = 0
    for s in specs:
        g_ref = gbuf[o: o + s.numel].view(s.shape)
        o += s.numel
        scale = float(g_ref.abs().max())
        assert scale > 0, s.path
        err = float((got[s.path].float() - g_ref).abs().max())
        # relative to the leaf's largest element: leaves sum over tokens
        assert err <= 1e-4 * scale, (s.path, err, scale)


def test_prefill_then_decode_equal_the_reference_forward():
    cfg, pcfg, tree, params, _ = _setup(seed=small.SEED + 1)
    S0, S = 13, 21
    tokens = _tokens(cfg, (2, S), seed=3)
    ref_lg = ref_model.logits(params, cfg, ref_model.hidden(params, cfg, tokens))
    with torch.no_grad():
        lg, cache = tm.prefill(tree, pcfg, {"tokens": tokens[:, :S0]}, cache_len=S)
        got = [lg[:, 0]]
        for p in range(S0, S):
            lg, cache = tm.decode_step(tree, pcfg, tokens[:, p: p + 1], cache)
            got.append(lg[:, 0])
    got = torch.stack(got, dim=1)[..., : cfg["vocab_size"]]
    torch.testing.assert_close(got, ref_lg[:, S0 - 1:].detach(), rtol=RTOL, atol=ATOL)


def _layer(seed: int, E: int = 72, d: int = 64, F: int = 16, Fs: int = 32):
    """An uncut expert layer's f32 params (all ``E`` experts), made by the
    program's initializer."""
    p = moe_lib.init_moe(torch.Generator().manual_seed(seed), d, F, E, True, True,
                         torch.float32, "cpu", shared_d_ff=Fs)
    p["router"] = p["router"] * (50.0 / math.sqrt(d))      # unit-spread router logits
    return p


def _share(p: dict, e0: int, n: int) -> dict:
    return dict(p, **{k: p[k][e0: e0 + n] for k in ("w_in", "w_gate", "w_out")})


KW = dict(num_experts=72, top_k=10, capacity_factor=1.25, act="silu", gated=True,
          dropless=True)


def _reference_moe(p: dict, h: torch.Tensor, e0: int, n: int) -> torch.Tensor:
    """The reference's expert layer (``families/hybrid.py``) over experts
    e0 .. e0+n-1 of the router's 72."""
    cfg = {"num_experts_per_tok": 10, "num_local_experts": n}
    leaves = {"moe/router": p["router"], "moe/w_in": p["w_in"][e0: e0 + n],
              "moe/w_gate": p["w_gate"][e0: e0 + n], "moe/w_out": p["w_out"][e0: e0 + n],
              **{f"moe/shared/{k}": v for k, v in p["shared"].items()}}
    return HYBRID._moe(h, leaves, cfg, False, e0)


def test_the_nine_shares_sum_to_the_uncut_layer():
    """Ranks 0..8 of the deployment's expert parallelism, each holding 8 of
    the 72 experts: their parts, with the shared expert counted once, add
    up to the uncut layer's output, and each share to the reference's."""
    p = _layer(4)
    h = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(5))
    parts = []
    for r in range(9):
        y, _ = moe_lib.moe_ffn(_share(p, 8 * r, 8), h, **KW, shared_expert=False,
                               held=(8 * r, 8))
        parts.append(y)
        ref = _reference_moe(p, h, 8 * r, 8) - mlp(p["shared"], h)
        torch.testing.assert_close(y, ref, rtol=RTOL, atol=ATOL)
    uncut, _ = moe_lib.moe_ffn(p, h, **KW, shared_expert=True)
    total = sum(parts) + mlp(p["shared"], h)
    torch.testing.assert_close(total, uncut, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(uncut, _reference_moe(p, h, 0, 72), rtol=RTOL, atol=ATOL)
    # every expert does some of the work: the shares are not empty
    assert all(float(y.abs().max()) > 0 for y in parts)


def test_dropless_keeps_every_assignment_when_every_token_picks_one_expert():
    """The router sends every token to expert 3 (and nine others): capacity
    routing would drop most of those assignments, dropless drops none; the
    held share's output equals the reference's, and its tally counts every
    held assignment."""
    p = _layer(6)
    T, d = 48, 64
    g = torch.Generator().manual_seed(7)
    base = torch.randn(d, generator=g)
    h = (base + 0.3 * torch.randn(1, T, d, generator=g))
    p["router"][:, 3] = 5.0 * base / base.norm()
    r = moe_lib.route(p["router"], h.reshape(T, d), 72, 10, 1.25)
    assert bool((r.gate_i == 3).any(-1).all())             # every token picked expert 3
    assert r.dropped > 0                                    # capacity routing drops
    obs_trace.enable()
    y, _ = moe_lib.moe_ffn(_share(p, 0, 8), h, **KW, shared_expert=True, held=(0, 8))
    tallies = obs_trace.get_tracer().tallies()
    torch.testing.assert_close(y, _reference_moe(p, h, 0, 8), rtol=RTOL, atol=ATOL)
    assert tallies["moe/held_rows"] == int((r.gate_i < 8).sum()) >= T
    assert tallies["moe/tokens"] == T


@pytest.mark.parametrize("name,family_name", [("h2o-danube-1.8b", "dense"),
                                              ("mamba2-2.7b", "ssm")])
def test_the_new_fields_leave_danube_and_mamba2_as_they_were(name, family_name):
    """Each new field at its default: the logits equal the families' plain
    references, and equal, bit for bit, a config that states the defaults
    (the softmax scale 1 / sqrt(hd) among them); remat per block equals no
    remat bit for bit."""
    cfg = small.reduced_config(name)
    pcfg = compare.program_config(cfg)
    assert (pcfg.embedding_multiplier, pcfg.residual_multiplier, pcfg.logits_scaling,
            pcfg.attn_scale, pcfg.nope) == (1.0, 1.0, 1.0, 0.0, False)
    w = make_weights(small.SEED, cfg, "cpu")
    tokens = _tokens(cfg, (2, 19))
    lg, _ = tm.forward_train(w.tree(), pcfg, {"tokens": tokens}, remat="none")
    params = ref_train.param_views(w.flat_f32(), leaf_specs(cfg))
    ref = ref_model.logits(params, cfg, ref_model.hidden(params, cfg, tokens))
    assert bench.load_json("configs", name)["family"] == family_name
    torch.testing.assert_close(lg[..., : cfg["vocab_size"]], ref, atol=2e-5, rtol=1e-4)
    stated = replace(pcfg, attn_scale=1.0 / math.sqrt(pcfg.head_dim) if pcfg.head_dim else 0.0)
    again, _ = tm.forward_train(w.tree(), stated, {"tokens": tokens}, remat="none")
    assert torch.equal(again, lg)
    with torch.enable_grad():
        leaves, td = tree_flatten(w.tree())
        req = [t.detach().clone().requires_grad_(True) for t in leaves]
        remat, _ = tm.forward_train(tree_unflatten(td, req), pcfg, {"tokens": tokens},
                                    remat="dots")
    assert torch.equal(remat.detach(), lg)


def test_the_expert_layer_spans_and_tally():
    """A training forward and backward with remat: each of the ten expert
    layers opens ``model/moe/forward`` twice (forward, recompute) and
    ``model/moe/backward`` once, after its recompute; the tally counts
    every call's tokens and the held assignments its routing made, read
    into a registry's counters on request.  Nothing is recorded with
    tracing off."""
    cfg, pcfg, tree, _, _ = _setup()
    tokens = _tokens(cfg, (1, 16))
    seen = []
    real = moe_lib._gates

    def gates(logits, k):
        out = real(logits, k)
        seen.append(out[2])
        return out

    leaves, td = tree_flatten(tree)
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    batch = {"tokens": tokens, "targets": tokens}
    loss, _ = tm.loss_fn(tree_unflatten(td, req), pcfg, batch, remat="dots")
    torch.autograd.grad(loss, req)
    assert obs_trace.get_tracer().n_recorded == 0 and obs_trace.get_tracer().tallies() == {}

    obs_trace.enable()
    moe_lib._gates = gates
    try:
        loss, _ = tm.loss_fn(tree_unflatten(td, req), pcfg, batch, remat="dots")
        torch.autograd.grad(loss, req)
    finally:
        moe_lib._gates = real
    spans = obs_trace.get_tracer().spans()
    names = [s.name for s in spans]
    assert names.count("model/moe/forward") == 20 and names.count("model/moe/backward") == 10
    assert len(seen) == 20
    n = cfg["num_local_experts"]
    reg = MetricsRegistry()
    reg.ingest_tallies(obs_trace.get_tracer())
    assert reg.get("moe/tokens").total == 20 * 16
    assert reg.get("moe/held_rows").total == sum(int((gi < n).sum()) for gi in seen)
    # the recompute routes as the forward did, last layer first
    assert all(torch.equal(a, b) for a, b in zip(seen[:10], seen[10:][::-1]))
    # each layer's backward span opens after its recompute's forward span
    # has closed, and holds no forward span
    fwd = [s for s in spans if s.name == "model/moe/forward"]
    bwd = [s for s in spans if s.name == "model/moe/backward"]
    for rec, b in zip(fwd[10:], bwd):
        assert rec.ts_us + rec.dur_us <= b.ts_us
        assert not any(b.ts_us <= f.ts_us < b.ts_us + b.dur_us for f in fwd)
    obs_trace.get_tracer().reset()
    assert obs_trace.get_tracer().tallies() == {}
