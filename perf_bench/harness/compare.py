"""The numbers ``correct`` compares, and the program's configuration built
from the benchmark's file."""
from __future__ import annotations

from typing import Optional

import torch

# the ModelConfig fields a configuration file states under the program's names
MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "sliding_window", "rope_theta", "norm_eps", "tie_embeddings",
              "dtype")


def program_config(cfg: dict):
    """The program's ModelConfig for the benchmark's configuration file: its
    registered architecture with every field the file states, as its
    family (``perf_bench/families/<family>.py``) maps them."""
    from dataclasses import replace

    from perf_bench.harness import bench
    from repro_torch.configs import get_config

    base = get_config(cfg["program_arch"])
    return replace(base, **bench.load_py("families", cfg["family"]).program_fields(cfg, base))


def loss_gap(prog, ref) -> float:
    """The widest relative gap between two lists of losses."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; ``keep`` masks the leaves compared."""
    prog, ref = prog.double(), ref.double()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    return (prog - ref).abs() / torch.maximum(ref, ref.median())


def norm_gap(prog: torch.Tensor, ref: torch.Tensor, keep: Optional[torch.Tensor] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return float(leaf_gaps(prog, ref, keep).max())


def median_gap(prog: torch.Tensor, ref: torch.Tensor, keep: Optional[torch.Tensor] = None) -> float:
    """The median leaf's gap (``leaf_gaps``): steady where a few small
    leaves' gradients are sums that cancel, which rounding moves."""
    return float(leaf_gaps(prog, ref, keep).median())


def moved(ref_grad: torch.Tensor) -> torch.Tensor:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the rest move under Adam by round-off alone."""
    return ref_grad.double() >= 1e-3 * ref_grad.double().median()
