"""Minimal pytree flattening over nested dicts, lists and tuples, and the
small tree algebra of ``repro/utils/tree.py`` over it.

Dicts flatten in sorted-key order, as ``jax.tree_util`` does, so a parameter
tree flattens to the same leaf order in both packages and bucket offsets,
payload bytes and ledger bytes agree.  ``None`` is an empty subtree.

The walkers are module-level functions that take their accumulator as an
argument: a recursive closure would form a reference cycle holding the leaf
list, and a full-width model's tensors would then live until the cyclic
garbage collector happened to run.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

SLICE_ELEMS = 1 << 26    # elements per slice of a leaf in ``tree_dot``


@dataclass(frozen=True)
class TreeDef:
    """Structure of a tree: ``kind`` is "leaf", "none", "dict", "list" or
    "tuple"; ``keys`` are the sorted dict keys; ``children`` the subtrees."""
    kind: str
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()


def _items(tree):
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return kind, tuple(range(len(tree))), list(tree)
    return None


def _flatten(t, leaves: list, path, paths) -> TreeDef:
    if t is None:
        return TreeDef("none")
    it = _items(t)
    if it is None:
        leaves.append(t)
        if paths is not None:
            paths.append("".join(f"[{k!r}]" for k in path))
        return TreeDef("leaf")
    kind, keys, subs = it
    return TreeDef(kind, keys, tuple(_flatten(s, leaves, path + (k,), paths)
                                     for k, s in zip(keys, subs)))


def tree_flatten(tree):
    """-> (leaves, TreeDef)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, (), None)


def tree_flatten_with_path(tree):
    """-> ([(keystr, leaf)], TreeDef); ``keystr`` formats the path as
    ``jax.tree_util.keystr`` does: ``"['blocks']['pos0']['norm1']['scale']"``."""
    leaves: list = []
    paths: list = []
    td = _flatten(tree, leaves, (), paths)
    return list(zip(paths, leaves)), td


def _unflatten(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    subs = [_unflatten(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, subs))
    return subs if td.kind == "list" else tuple(subs)


def tree_unflatten(treedef: TreeDef, leaves):
    return _unflatten(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, td = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def tree_size(tree) -> int:
    """Total number of scalar elements in the tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total number of bytes of the tree's leaves."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, tree):
    """``s * x`` per leaf.  A Python number is first rounded to each floating
    leaf's dtype, as JAX's weak typing does (bf16 leaves: one rounding of
    ``s`` to bf16 before the product, not a product with ``s`` in f32)."""
    def scale(x):
        if isinstance(s, (int, float)) and x.is_floating_point():
            return x * torch.tensor(s, dtype=x.dtype).item()
        return s * x
    return tree_map(scale, tree)


def leaf_slices(t: torch.Tensor, elems: int = SLICE_ELEMS):
    """Index slices of ``t`` along its first axis, about ``elems`` elements
    each; one ``slice(None)`` for a leaf no wider."""
    if t.dim() == 0 or t.numel() <= elems:
        yield slice(None)
        return
    per = max(1, elems // max(1, t[0].numel()))
    for i in range(0, t.shape[0], per):
        yield slice(i, i + per)


def _leaf_dot(x: torch.Tensor, y: torch.Tensor, elems: int) -> torch.Tensor:
    """f32 sum of ``x * y`` over one leaf, ``elems`` elements at a time: a
    leaf wider than that (mamba2-2.7b's stacked ``in_proj``, 1.73e9
    elements) never gets whole f32 temporaries, which cost 12 B an element."""
    parts = [(x[sl].float() * y[sl].float()).sum() for sl in leaf_slices(x, elems)]
    return functools.reduce(torch.add, parts[1:], parts[0])


def tree_dot(a, b, slice_elems: int = SLICE_ELEMS) -> torch.Tensor:
    """Sum of elementwise products across two same-structure trees: a 0-d f32
    tensor on the leaves' device, per-leaf sums added in leaf order.

    A sum of products per leaf, never a flattening ``vdot``: a flattened
    DTensor shard cannot keep its placements, so ``reshape(-1)`` would gather
    the whole tensor (as the reference's note says of GSPMD)."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    parts = [_leaf_dot(x, y, slice_elems) for x, y in zip(xs, ys)]
    return functools.reduce(torch.add, parts, parts[0].new_zeros(()))


def tree_norm(tree, slice_elems: int = SLICE_ELEMS) -> torch.Tensor:
    """Euclidean norm of the concatenated tree (``sqrt(tree_dot(t, t))``)."""
    return torch.sqrt(tree_dot(tree, tree, slice_elems))


def global_norm(tree) -> torch.Tensor:
    return tree_norm(tree)
