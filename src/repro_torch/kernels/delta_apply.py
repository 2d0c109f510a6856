"""D1: one slot's delta apply, written into the serving engine's parameter
tree in place.

A slot's parameters are ``debucketize(base + pool[table])``
(``serve.engine``): f32 base blocks, the pool's f32 delta rows picked by the
user's block table, each leaf in the dtype the layout records.
:func:`delta_apply` writes them into a tree from ``comm.buckets.empty_tree``
at the addresses it already has.  CUDA tensors run kernel D1
(``csrc/delta.cu``): one pass that reads base and the pool's rows once and
stores each element in its leaf's dtype, 10 B an element of a bf16 tree
and no f32 ``eff``.  CPU tensors run the plain version,
:func:`delta_apply_plain`: a gather, an f32 add and a cast per leaf.  Both
are bit for bit ``debucketize(index_select(pool, table) + base)``.

D1 walks a work list that the host builds once per tree (:func:`work_list`
from :func:`pieces`): pieces of at most ``PIECE`` elements, each inside one
leaf, so a launch carries only pointers and counts.  Building it checks the
tree and the layout; a call checks only its base, pool and table.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.comm.buckets import BucketLayout, debucketize, to_dtype
from repro_torch.kernels import build
from repro_torch.utils.tree import tree_flatten

PIECE = 1 << 14                 # elements a piece of the work list holds at most
DTYPES = (torch.bfloat16, torch.float32)    # the leaf dtypes D1 stores


def pieces(layout: BucketLayout, cap: int = PIECE) -> np.ndarray:
    """The work list's pieces of ``layout``: (n, 4) int64 rows (leaf index,
    flat start, length, is_bf16), in flat order, each inside one leaf and at
    most ``cap`` long; together they cover ``[0, layout.d)`` once."""
    rows = [np.zeros((0, 4), np.int64)]
    for j, (off, size, dt) in enumerate(zip(layout.offsets, layout.sizes, layout.dtypes)):
        starts = np.arange(off, off + size, cap, dtype=np.int64)
        lens = np.minimum(cap, off + size - starts)
        bf16 = int(to_dtype(dt) == torch.bfloat16)
        rows.append(np.stack([np.full_like(starts, j), starts, lens,
                              np.full_like(starts, bf16)], axis=1))
    return np.concatenate(rows)


def work_list(layout: BucketLayout, tree) -> torch.Tensor:
    """D1's work list for ``tree``, whose leaves must keep their addresses:
    (n, 4) int64 on the tree's device, rows (address of the piece's first
    output element, flat start, length, is_bf16).

    The tree's one check: raise unless each leaf is contiguous, on the
    first leaf's device, of the layout's shape and dtype, and a dtype D1
    stores, and unless the bucket size is a power of two of at least 4."""
    leaves = tree_flatten(tree)[0]
    if len(leaves) != len(layout.shapes):
        raise ValueError(f"tree has {len(leaves)} leaves, layout {len(layout.shapes)}")
    device = leaves[0].device
    for j, (leaf, shape, dt) in enumerate(zip(leaves, layout.shapes, layout.dtypes)):
        if to_dtype(dt) not in DTYPES:
            raise TypeError(f"leaf {j}: dtype {dt}; D1 stores bfloat16 or float32")
        build.check_tensor(leaf, f"leaf {j}", to_dtype(dt), shape, device,
                           align=leaf.element_size())
    bs = layout.bucket_size
    if bs < 4 or bs & (bs - 1):
        raise ValueError(f"bucket size {bs}: D1 takes a power of two of at least 4")
    rows = pieces(layout)
    j = rows[:, 0]
    ptr = np.asarray([leaf.data_ptr() for leaf in leaves], np.int64)[j]
    esize = np.asarray([leaf.element_size() for leaf in leaves], np.int64)[j]
    off = np.asarray(layout.offsets, np.int64)[j]
    rows[:, 0] = ptr + (rows[:, 1] - off) * esize
    return torch.as_tensor(rows).to(device)


def delta_apply_plain(base_blocks: torch.Tensor, pool_blocks: torch.Tensor,
                      table: torch.Tensor, tree, layout: BucketLayout):
    """The plain version: the gather into an f32 ``eff``, the add, and
    ``debucketize(..., out=tree)``'s cast per leaf.  Returns ``tree``."""
    # pool[table] + base == base + pool[table]: IEEE addition commutes
    eff = torch.index_select(pool_blocks, 0, table).add_(base_blocks)
    return debucketize(eff, layout, out=tree)


def delta_apply(base_blocks: torch.Tensor, pool_blocks: torch.Tensor,
                table: torch.Tensor, tree, layout: BucketLayout,
                work: Optional[torch.Tensor] = None):
    """Write ``debucketize(base_blocks + pool_blocks[table])`` into ``tree``
    in place and return it.  ``base_blocks`` (n_blocks, bs) and
    ``pool_blocks`` (rows, bs) f32, ``table`` (n_blocks,) int32 rows of the
    pool.  ``work`` is :func:`work_list` of ``tree`` and ``layout``, which
    checked them once.

    Every entry of ``table`` must be below ``pool_blocks.shape[0]``: the
    plain version's ``index_select`` raises on a row out of range, D1 reads
    the pool there unchecked (the engine's tables come from ``BlockPool``,
    whose rows they index).

    CPU tensors run the plain version, which needs no ``work``; CUDA
    tensors launch D1 over ``work``, and raise without it."""
    nb, bs = layout.n_buckets, layout.bucket_size
    build.check_tensor(base_blocks, "base_blocks", torch.float32, (nb, bs))
    device = base_blocks.device
    build.check_tensor(pool_blocks, "pool_blocks", torch.float32,
                       (pool_blocks.shape[0], bs), device)
    build.check_tensor(table, "table", torch.int32, (nb,), device, align=4)
    if device.type == "cpu":
        return delta_apply_plain(base_blocks, pool_blocks, table, tree, layout)
    build.require_cuda(base_blocks)
    if work is None:
        raise ValueError("D1 writes the tree through its work list: pass "
                         "work_list(layout, tree)")
    build.check_tensor(work, "work", torch.int64, (work.shape[0], 4), device, align=8)
    build.launch("repro_delta_apply", device, base_blocks, pool_blocks, table, work,
                 work.shape[0], bs.bit_length() - 1)
    delta_apply.launches += 1
    return tree


delta_apply.launches = 0
