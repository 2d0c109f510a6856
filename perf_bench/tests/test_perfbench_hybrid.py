"""The ``hybrid`` family (granite-4.0-h-small) and its cell
``granite-train-efbv``: the family's contract, its layout against the
program's tree, its flop counts against a hand count, the expert layer's
readers, and the cell's comparison: ``correct`` for the bf16 program at a
size a test run holds, not for the float8 control, a state left unchanged
or half the batch."""
from __future__ import annotations

import pytest
import torch

from perf_bench.harness import bench, compare
from perf_bench.harness.weights import check_program_tree, leaf_specs
from perf_bench.metrics import counts
from perf_bench.tests import small
from perf_bench.tests.test_perfbench_faults import _correct, _half_batch, _unchanged, _wrap_step
from perf_bench.tests.test_perfbench_families import CONTRACT

NAME, CELL = "granite-4.0-h-small", "granite-train-efbv"
FAM = bench.load_py("families", "hybrid")


def test_the_family_has_the_contract_and_the_expert_layer_counts():
    missing = [k for k in CONTRACT + ("logits", "held_share", "moe_flops") if not hasattr(FAM, k)]
    assert not missing
    assert FAM.POSITIONAL is True


def test_the_file_states_the_cut_and_agrees_with_itself():
    """config.json's keys and the harness's names for one size agree; the
    cut is the period, the share of experts and the vocabulary slice."""
    cfg = bench.load_json("configs", NAME)
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["rms_norm_eps"],
            cfg["tie_word_embeddings"]) == (cfg["d_model"], cfg["num_layers"], cfg["norm_eps"],
                                            cfg["tie_embeddings"])
    assert cfg["mamba_n_heads"] == cfg["mamba_expand"] * cfg["d_model"] // cfg["mamba_d_head"]
    assert cfg["num_layers"] == len(cfg["layer_types"]) == 10
    assert cfg["layer_types"].count("attention") == 1
    assert (cfg["router_experts"], cfg["num_local_experts"], cfg["num_experts_per_tok"]) == (72, 8, 10)
    assert cfg["vocab_size"] * 8 == cfg["published"]["vocab_size"]
    assert set(cfg["reduced"]) == {"num_hidden_layers", "num_layers", "num_local_experts",
                                   "vocab_size", "layer_types"}
    assert [c for c in bench.manifest()["configs"] if c["name"] == NAME][0]["reduced"] \
        == cfg["reduced"]


@pytest.mark.parametrize("reduced", [False, True])
def test_the_layout_is_the_program_tree(reduced):
    from repro_torch.models import init_params
    cfg = small.reduced_config(NAME, layers=None) if reduced else bench.load_json("configs", NAME)
    specs = leaf_specs(cfg)
    check_program_tree(specs, init_params(0, compare.program_config(cfg), device="meta"))
    assert sum(s.numel for s in specs) == (1_779_664 if reduced else 1_960_659_584)


HAND = {"family": "hybrid", "num_layers": 2, "d_model": 4, "vocab_size": 5,
        "layer_types": ["mamba", "attention"], "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 3, "shared_intermediate_size": 2,
        "router_experts": 6, "num_local_experts": 2, "num_experts_per_tok": 3,
        "mamba_expand": 2, "mamba_d_head": 4, "mamba_d_state": 3, "mamba_n_groups": 1}


def test_flops_by_hand():
    # Mamba2: d_inner 8, 2 heads of 4, state 3: in_proj 4 x (16 + 6 + 2), out_proj 8 x 4
    mamba = 4 * 24 + 8 * 4
    # attention: q 4x4, k and v 4x2 each (head 2), o 4x4
    attn = 16 + 8 + 8 + 16
    # an expert layer: router 4 x 6, the shared SwiGLU 3 x 4 x 2, held share
    # 3 x 2 / 6 = 1 assignment a token of a 3 x 4 x 3 SwiGLU
    moe = 24 + 24 + 36
    assert FAM.held_share(HAND) == 1.0
    assert counts.body_weights(HAND) == mamba + attn + 2 * moe
    # the recurrence 4 x 2 x 4 x 3; QK and PV 4 x 2 heads x 2 x ctx
    assert counts.mixer_flops(HAND, 5) == 96 + 16 * 5
    assert counts.token_flops(HAND, 1, True) == 2 * (mamba + attn + 2 * moe) + 96 + 16 + 40
    assert FAM.moe_flops(HAND, 10, 25) == 2 * (10 * 48 + 25 * 36)


def _run(**kw):
    r = bench.Run(config=dict(HAND), cell={}, traffic={"seq_len": 8, "global_batch": 2})
    r.numbers = {"steps": 2}
    r.window_s = 1.0
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_the_expert_layer_readers(monkeypatch):
    from repro_torch.obs import trace
    rd = lambda name, run: bench.load_py("metrics", name).read(run)  # noqa: E731
    trace.get_tracer().reset()
    assert rd("moe_ms.train", _run()) is None
    assert rd("moe_mfu.train", _run()) is None
    spans = [("model/moe/forward", 1.0, 3.0), ("model/moe/backward", 1.0, 5.0),
             ("model/attn/forward", 1.0, 7.0), ("model/moe/forward", 1.0, 2.0)]
    assert rd("moe_ms.train", _run(spans=spans)) == pytest.approx(5.0)
    trace.enable()
    try:
        trace.tally("moe/held_rows", torch.tensor(30))
        trace.tally("moe/held_rows", torch.tensor(18, dtype=torch.int32))
        trace.tally("moe/tokens", 24)
        trace.tally("moe/tokens", 24)
    finally:
        trace.disable()
    # 2 steps x 16 tokens x 2 layers, a row each: 3 x moe_flops over 10 ms
    want = 100.0 * 3 * FAM.moe_flops(HAND, 64, 64) / 0.010 / counts.PEAK_FLOPS_BF16
    assert rd("moe_mfu.train", _run(spans=spans)) == pytest.approx(want)
    trace.get_tracer().reset()
    assert rd("moe_mfu.train", _run(spans=spans)) is None


def _context(**kw):
    """The cell at the family's test sizes with rows of 256 tokens: the
    gradient's rounding in bf16 averages over a row's tokens, and at the
    harness's 48 the program's median leaf reads 3x what the card's 4,096
    read (0.0016-0.0020 against 2.0e-4-2.2e-4)."""
    ctx = small.context(CELL, dtype="bfloat16", **kw)
    ctx.traffic["seq_len"] = 256
    return ctx


def test_the_bf16_program_is_correct():
    run = small.run(_context())
    assert _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def test_the_float8_control_fails_a_limit():
    run = small.run(_context(control=True))
    assert {c.name for c in run.control} == set(run.cell["limits"])
    line = bench.result_line(run, {}, {}, None, control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_train_fault_is_not_correct(fault, monkeypatch):
    _wrap_step(monkeypatch, {"unchanged": _unchanged, "half_batch": _half_batch}[fault])
    run = small.run(_context())
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]
