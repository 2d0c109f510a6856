"""Reduced configurations and contexts for the CPU tests: the cells' own
files with every size cut so a test run holds them."""
from __future__ import annotations

import copy
import time

import torch

from perf_bench.harness import bench

SEED = 3_141_592_653_589     # larger than 32 signed bits, as the driver's seeds are
# a serving window long enough that requests finish, and are judged, on a
# loaded CPU
SECONDS = {"train": 2.0, "closed": 6.0}


def reduced_config(name: str, dtype: str = "float32", layers: int = 2) -> dict:
    c = copy.deepcopy(bench.load_json("configs", name))
    if c["family"] == "dense":
        c.update(num_layers=layers, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                 d_ff=256, vocab_size=512, sliding_window=24)
    else:
        c.update(num_layers=layers, d_model=128, vocab_size=500)
        c["mamba"].update(d_state=16, head_dim=16, chunk_size=8)
    c["dtype"] = dtype
    return c


def context(cell_name: str, dtype: str = "float32", seed: int = SEED, seconds: float = 0.0,
            control: bool = False, layers: int = 0) -> bench.Context:
    cell = copy.deepcopy(bench.load_json("cells", cell_name))
    # mamba2 keeps all its layers: a served token's rounding gap grows with
    # depth, and the float8 control's must reach the cell's limit
    full = bench.load_json("configs", cell["config"])
    cfg = reduced_config(cell["config"], dtype, layers or (
        full["num_layers"] if full["family"] == "ssm" else 2))
    tr = copy.deepcopy(bench.load_json("traffic", cell["traffic"]))
    if tr["kind"] == "train":
        tr.update(seq_len=48)
    else:
        tr.update(prompt=dict(median=12, sigma=0.7, min=4, max=30),
                  output=dict(median=4, sigma=0.7, min=2, max=8), requests=64)
        cell.update(max_len=48, check_tokens=64)
    return bench.Context(cell_name, cell, cfg, tr, seed, seconds or SECONDS[tr["kind"]], False,
                         torch.device("cpu"), time.perf_counter(), control)


def run(ctx: bench.Context) -> bench.Run:
    return bench.load_py("drivers", ctx.cell["driver"]).run(ctx)
