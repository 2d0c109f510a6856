"""Device resolution and seeded generators.

Entry points of the port run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where there is none.  Randomness
always comes from an explicit ``torch.Generator`` made here from an integer
seed, never from global RNG state.
"""
from __future__ import annotations

import hashlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def fold_seed(seed: int, data: int) -> int:
    """Derive an independent 63-bit seed from ``(seed, data)`` (the role of
    ``jax.random.fold_in``; not its values)."""
    h = hashlib.blake2b(f"{int(seed)}:{int(data)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def make_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``: two calls with
    the same seed draw the same numbers."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
