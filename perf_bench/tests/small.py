"""Reduced configurations and contexts for the CPU tests: the cells' own
files with every size cut so a test run holds them."""
from __future__ import annotations

import copy
import time
from typing import Optional

import torch

from perf_bench.harness import bench

SEED = 3_141_592_653_589     # larger than 32 signed bits, as the driver's seeds are
# a serving window long enough that requests finish, and are judged, on a
# loaded CPU
SECONDS = {"train": 2.0, "closed": 6.0}


def reduced_config(name: str, dtype: str = "float32", layers: Optional[int] = 2) -> dict:
    """The configuration file at its family's test sizes (``reduced``), with
    ``layers`` layers where given, else the family's test depth."""
    c = copy.deepcopy(bench.load_json("configs", name))
    c.update(bench.load_py("families", c["family"]).reduced(c))
    if layers:
        c["num_layers"] = layers
    c["dtype"] = dtype
    return c


def context(cell_name: str, dtype: str = "float32", seed: int = SEED, seconds: float = 0.0,
            control: bool = False, layers: int = 0) -> bench.Context:
    cell = copy.deepcopy(bench.load_json("cells", cell_name))
    cfg = reduced_config(cell["config"], dtype, layers or None)
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
