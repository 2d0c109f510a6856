"""Bucket fusion: flatten a parameter tree into fixed-size f32 buckets
(port of ``repro/comm/buckets.py``).

Leaves are flattened in sorted-key order, as ``jax.tree_util`` does, so the
offsets, and with them the delta block space, payload bytes and ledger bytes,
equal the JAX package's.  The flat buffer is written leaf by leaf into one
preallocated tensor: a full-width model never holds a second f32 copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.utils.tree import TreeDef, tree_flatten, tree_unflatten

DEFAULT_BUCKET_SIZE = 1 << 16


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the JAX package's spelling)."""
    return str(dtype).split(".")[-1]


def to_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


@dataclass(frozen=True)
class BucketLayout:
    """Where each leaf lives inside the flat bucketed vector."""
    treedef: TreeDef
    shapes: Tuple[tuple, ...]    # per-leaf shapes (group axis excluded)
    dtypes: Tuple[str, ...]      # per-leaf dtype names
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    d: int
    bucket_size: int

    @property
    def n_buckets(self) -> int:
        return max(1, -(-self.d // self.bucket_size))

    @property
    def padded_d(self) -> int:
        return self.n_buckets * self.bucket_size


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _layout(leaves, treedef, bucket_size: int, group_axis: bool) -> BucketLayout:
    shapes = tuple(tuple(l.shape[1:] if group_axis else l.shape) for l in leaves)
    sizes = tuple(_prod(s) for s in shapes)
    offsets, acc = [], 0
    for s in sizes:
        offsets.append(acc)
        acc += s
    return BucketLayout(treedef, shapes, tuple(dtype_name(l.dtype) for l in leaves),
                        sizes, tuple(offsets), acc, int(bucket_size))


def bucket_layout(tree, bucket_size: int = DEFAULT_BUCKET_SIZE) -> BucketLayout:
    """The layout ``bucketize(tree, bucket_size)`` would use."""
    leaves, treedef = tree_flatten(tree)
    return _layout(leaves, treedef, bucket_size, group_axis=False)


def bucketize_into(tree, out: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Write ``tree`` into the preallocated f32 ``out`` (padded_d elements,
    any shape) as ``bucketize`` lays it out, zero tail included; returns
    ``out``.  How a step fills one group's row of a (G, nb, B) buffer
    without a second copy of the tree."""
    flat = out.view(-1)
    for leaf, off, size in zip(tree_flatten(tree)[0], layout.offsets, layout.sizes):
        flat[off: off + size].copy_(leaf.reshape(-1))
    flat[layout.d:].zero_()
    return out


def bucketize(tree, bucket_size: int = DEFAULT_BUCKET_SIZE):
    """Tree -> ((n_buckets, bucket_size) float32, BucketLayout)."""
    leaves = tree_flatten(tree)[0]
    layout = bucket_layout(tree, bucket_size)
    flat = torch.empty(layout.padded_d, dtype=torch.float32,
                       device=leaves[0].device)
    bucketize_into(tree, flat, layout)
    return flat.view(layout.n_buckets, layout.bucket_size), layout


def bucketize_groups(tree_g, bucket_size: int = DEFAULT_BUCKET_SIZE):
    """Tree with leading group axis G -> ((G, n_buckets, bucket_size) f32,
    BucketLayout of the per-group view)."""
    leaves, treedef = tree_flatten(tree_g)
    layout = _layout(leaves, treedef, bucket_size, group_axis=True)
    G = leaves[0].shape[0]
    flat = torch.empty((G, layout.padded_d), dtype=torch.float32,
                       device=leaves[0].device)
    for leaf, off, size in zip(leaves, layout.offsets, layout.sizes):
        flat[:, off: off + size].copy_(leaf.reshape(G, -1))
    flat[:, layout.d:].zero_()
    return flat.view(G, layout.n_buckets, layout.bucket_size), layout


def empty_tree(layout: BucketLayout, device=None):
    """An uninitialized tree of ``layout``'s leaves, each of its recorded
    shape and dtype: what ``debucketize(..., out=)`` writes in place."""
    leaves = [torch.empty(shape, dtype=to_dtype(dt), device=device)
              for shape, dt in zip(layout.shapes, layout.dtypes)]
    return tree_unflatten(layout.treedef, leaves)


def debucketize(buckets: torch.Tensor, layout: BucketLayout, dtype=None, out=None):
    """Inverse of ``bucketize``; ``dtype`` overrides the recorded leaf dtypes.
    A leaf whose dtype is already f32 is a view into ``buckets``.  With
    ``out`` (a tree from ``empty_tree``) every leaf is cast and copied into
    ``out``'s, at the addresses it already has, and ``out`` is returned: the
    same values, bit for bit."""
    flat = buckets.reshape(-1)[: layout.d]
    views = [flat[off: off + size].view(shape)
             for shape, size, off in zip(layout.shapes, layout.sizes, layout.offsets)]
    if out is not None:
        for leaf, v in zip(tree_flatten(out)[0], views):
            leaf.copy_(v)
        return out
    leaves = [v.to(to_dtype(dtype or dt)) for v, dt in zip(views, layout.dtypes)]
    return tree_unflatten(layout.treedef, leaves)


def debucketize_groups(buckets_g: torch.Tensor, layout: BucketLayout, dtype=None):
    """Inverse of ``bucketize_groups`` (leading group axis preserved)."""
    G = buckets_g.shape[0]
    flat = buckets_g.reshape(G, -1)[:, : layout.d]
    leaves = [flat[:, off: off + size].reshape((G,) + shape).to(to_dtype(dtype or dt))
              for shape, dt, size, off in zip(layout.shapes, layout.dtypes,
                                              layout.sizes, layout.offsets)]
    return tree_unflatten(layout.treedef, leaves)
