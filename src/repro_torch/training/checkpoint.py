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
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.interop import numpy_from_tensor
from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten


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


def _leaf(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """One stored array as a tensor of ``like``'s dtype on ``device`` (the
    array's own memory until the move: no host copy)."""
    arr = np.ascontiguousarray(arr)
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bf16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype.kind == "V":
        raise ValueError(f"a {like.dtype} leaf stored as {arr.dtype}")
    return torch.from_numpy(arr).to(device=device, dtype=like.dtype)


def stored_shape(path: str, i: int = 0) -> tuple:
    """The shape of leaf ``i`` as stored, from its ``.npy`` header alone (no
    data is read)."""
    with zipfile.ZipFile(_base(path) + ".npz") as z, z.open(f"leaf_{i}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return tuple(read(f)[0])


def load_checkpoint(path: str, like_tree, replica: Optional[int] = None, device=None):
    """Restore into the structure, dtypes, shapes and devices of
    ``like_tree`` -> (tree, step).

    The checkpoint must hold exactly ``like_tree``'s leaves: its manifest's
    key paths equal the tree's, and every stored shape equals its leaf's;
    otherwise ValueError, and nothing is re-initialized.  ``replica`` reads
    a checkpoint of a replica run (``local`` / ``hier``), whose every leaf
    carries a leading replica axis: it takes that replica.  ``device``
    places every leaf there instead of on its like leaf's device (for a
    ``meta``-device ``like_tree``, a structure without storage)."""
    with open(_base(path) + ".json") as f:
        meta = json.load(f)
    flat, treedef = tree_flatten_with_path(like_tree)
    want = {f"leaf_{i}": keystr for i, (keystr, _) in enumerate(flat)}
    if meta["manifest"] != want:
        extra = sorted(set(meta["manifest"].values()) - set(want.values()))
        missing = sorted(set(want.values()) - set(meta["manifest"].values()))
        raise ValueError(f"{path}: the checkpoint's keys are not the tree's "
                         f"(only in the checkpoint: {extra[:4]}; only in the tree: "
                         f"{missing[:4]}; or another order)")
    restored = []
    with np.load(_base(path) + ".npz") as data:
        for i, (keystr, like) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            shape = tuple(like.shape)
            if replica is not None:
                if arr.ndim != len(shape) + 1 or not 0 <= replica < arr.shape[0]:
                    raise ValueError(f"{path}: {keystr} has shape {arr.shape}, not "
                                     f"(replicas > {replica}, *{shape})")
                arr = arr[replica]
            if tuple(arr.shape) != shape:
                raise ValueError(f"{path}: {keystr} has shape {tuple(arr.shape)}, "
                                 f"the tree's leaf {shape}")
            restored.append(_leaf(arr, like, like.device if device is None else device))
            del arr
    return tree_unflatten(treedef, restored), meta["step"]
