"""Minimal pytree flattening over nested dicts, lists and tuples.

Dicts flatten in sorted-key order, as ``jax.tree_util`` does, so a parameter
tree flattens to the same leaf order in both packages and bucket offsets,
payload bytes and ledger bytes agree.  ``None`` is an empty subtree.

The walkers are module-level functions that take their accumulator as an
argument: a recursive closure would form a reference cycle holding the leaf
list, and a full-width model's tensors would then live until the cyclic
garbage collector happened to run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
