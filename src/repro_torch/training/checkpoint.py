"""Checkpoints: a flat-key ``.npz`` plus a JSON manifest (port of
``repro/training/checkpoint.py``).

The format is the JAX package's: leaves ``leaf_{i}`` in the tree's sorted-
key flatten order, and ``{"step", "manifest": {leaf_i: keystr}}`` beside
them.  numpy has no bfloat16 of its own: the port writes a bf16 leaf as its
uint16 bit pattern and records ``"dtypes": {leaf_i: "bfloat16"}`` in the
manifest, and reads a bf16 leaf from either a uint16 array or the 2-byte
void array a JAX-package checkpoint holds (``ml_dtypes.bfloat16`` saved by
numpy), keeping the bits.

Directions: the port loads a JAX-package checkpoint leaf for leaf, bit for
bit.  A JAX-package reader loads the port's f32 leaves as they are; its
``astype`` would convert the port's uint16 bf16 leaves by value, so such a
reader must view them as ``ml_dtypes.bfloat16`` using the manifest's
``dtypes``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.interop import numpy_from_tensor, tensor_from_numpy
from repro_torch.utils.tree import tree_flatten_with_path, tree_flatten, tree_unflatten


def _base(path: str) -> str:
    return path.replace(".npz", "")


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, manifest, dtypes = {}, {}, {}
    for i, (keystr, leaf) in enumerate(tree_flatten_with_path(tree)[0]):
        key = f"leaf_{i}"
        arrays[key] = numpy_from_tensor(leaf)
        manifest[key] = keystr
        if leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
    np.savez(_base(path) + ".npz", **arrays)
    with open(_base(path) + ".json", "w") as f:
        json.dump({"step": step, "manifest": manifest, "dtypes": dtypes}, f)


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bf16 leaf stored as {arr.dtype}")
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).reshape(like.shape).to(like.device)
    if arr.dtype.kind == "V":
        raise ValueError(f"a {like.dtype} leaf stored as {arr.dtype}")
    return tensor_from_numpy(arr, like.device).to(like.dtype).reshape(like.shape)


def load_checkpoint(path: str, like_tree):
    """Restore into the structure, dtypes, shapes and devices of
    ``like_tree`` -> (tree, step)."""
    data = np.load(_base(path) + ".npz")
    leaves, treedef = tree_flatten(like_tree)
    restored = [_leaf(data[f"leaf_{i}"], leaf) for i, leaf in enumerate(leaves)]
    with open(_base(path) + ".json") as f:
        meta = json.load(f)
    return tree_unflatten(treedef, restored), meta["step"]
