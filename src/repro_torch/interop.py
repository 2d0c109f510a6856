"""Carry the JAX package's parameters into the port's tree.

The caller converts the JAX tree to numpy (``tree_map(np.asarray, params)``);
this module never imports JAX.  bf16 arrays arrive as ``ml_dtypes.bfloat16``
and cross through a ``uint16`` view into ``torch.bfloat16``, bit for bit —
never through a wider float.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_jax(tree_of_numpy, device=None):
    """A tree of numpy arrays (the JAX package's params) -> the same tree of
    tensors on ``device`` (``None`` -> the card)."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree_of_numpy)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """Inverse direction for one tensor; bf16 comes back as its ``uint16``
    bit pattern (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
