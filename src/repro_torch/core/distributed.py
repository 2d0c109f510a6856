"""Gradient and replica synchronization across worker groups (port of
``repro/core/distributed.py``).

A worker group is the federated "client".  The group axis is a batch
dimension here: one card holds every group, and a mean over it stands for
the all-reduce.

Modes (``SyncConfig.mode``):
  dense         mean over groups
  efbv          EF-BV compressed delta sync (Ch. 2): the optimizer's gradient
                estimate is h_bar + nu * mean_i C_i(g_i - h_i)
  ef21 / diana  parameter special cases of efbv
  hier / local  per-group replicas synced every ``sync_period`` steps through
                an EF21-compressed delta against an anchor (Cohort-Squeeze,
                Ch. 5), or through an aggregation-tree cascade of anchors

Differences from the JAX package, none of which changes a value:

* **Draws.**  A function that compresses takes ``noise=`` (the compressor's
  draws, nested as documented per function, in the order the JAX package
  splits its keys) or ``generator=``; there is no key.
* **Host step counter.**  ``SyncState.step`` and ``TreeSyncState.step`` are
  Python ints, so ``lax.cond``/``lax.switch`` on the number of levels that
  sync this step become Python branches; a device scalar read every step
  would cost a synchronization.
* **In place.**  The state is updated in place and returned, as the jitted
  JAX step donates it.  On the fused path (``bucket_size > 0`` and a
  ``flatten=True`` compressor) ``h`` and ``h_bar`` stay in their bucketed
  form between steps, (G, nb, B) and (nb, B) f32 with ``SyncState.layout``
  set; ``sync_state_trees`` gives them back as trees.
* **Kernel B1 in chunks.**  ``qsgd_kernel`` on the fused path runs B1 over
  chunks of whole 8 x 512 tiles of the bucket buffer in place.  B1 is
  row-local, so the chunked call equals the whole call bit for bit given
  the same draws, and no second (G, d) buffer is ever allocated.

Exactness: every update is written as the reference's separate operations
(``h + lam * d_i`` is a multiply, then an add; a mean is a sum, then a
division), never as a fused multiply-add, and a mean over the group axis
sums in XLA's order (``group_sum``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.comm import buckets as bk
from repro_torch.configs.base import SyncConfig
from repro_torch.core import compressors as comp_lib
from repro_torch.core.compressors import Compressor
from repro_torch.kernels import quant8
from repro_torch.kernels.ops import tile_rows
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

# rows of B1's (rows, 512) view per chunk on the fused path (whole tiles)
CHUNK_ROWS = 1 << 16
# XLA's CPU backend sums more than this many terms as windows of this many
REDUCE_WINDOW = 32


def group_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in the order XLA sums it: from zero, term by term,
    for up to REDUCE_WINDOW terms; beyond that, windows of REDUCE_WINDOW
    terms (the padding to whole windows split evenly, the odd one high),
    each summed so, then the window sums summed the same way.  For the two
    groups of a card run it is simply ``x[0] + x[1]``."""
    n = x.shape[dim]
    if n <= REDUCE_WINDOW:
        acc = torch.zeros_like(x.select(dim, 0))
        for i in range(n):
            acc.add_(x.select(dim, i))
        return acc
    m = -(-n // REDUCE_WINDOW)
    lo = (m * REDUCE_WINDOW - n) // 2
    parts = []
    for k in range(m):
        a, b = max(0, k * REDUCE_WINDOW - lo), min(n, (k + 1) * REDUCE_WINDOW - lo)
        parts.append(group_sum(x.narrow(dim, a, b - a), dim))
    return group_sum(torch.stack(parts, dim), dim)


def group_mean(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.mean`` over ``dim``: ``group_sum``, then a division."""
    return group_sum(x, dim).div_(x.shape[dim])


class SyncState(NamedTuple):
    """EF-BV state: per-group control variates ``h`` (leading group axis)
    and their running average ``h_bar``, both f32; ``layout`` is set when
    they are held bucketed (the fused path)."""
    h: object
    h_bar: object
    step: int
    layout: Optional[bk.BucketLayout] = None


class TreeSyncState(NamedTuple):
    """Anchor cascade state: ``anchors[l]`` is level l's anchor tree, leaf-
    most level first; non-root anchors carry a leading node axis, the root's
    is unstacked (``SyncState.h_bar``'s shape)."""
    anchors: Tuple[object, ...]
    step: int


class CascadeLevel(NamedTuple):
    """Runtime spec of one cascade level (built from LevelConfig + tree)."""
    name: str
    compressor: Compressor
    lam: float
    period: int
    fanout: int


def make_sync_compressor(name: str, compress_ratio: float,
                         quant_bits: int) -> Compressor:
    """The registry mapping the runtime sync paths use (``qsgd`` resolves to
    the last-axis ``qsgd_sharded``, as in the JAX package)."""
    if name == "topk_block":
        return comp_lib.block_top_k(compress_ratio)
    if name == "rand_k":
        return comp_lib.rand_k(compress_ratio)
    if name == "top_k":
        return comp_lib.top_k(compress_ratio)
    if name == "qsgd":
        return comp_lib.qsgd_sharded(quant_bits)
    if name == "identity":
        return comp_lib.identity()
    return comp_lib.make_compressor(name)


def build_compressor(sync: SyncConfig) -> Compressor:
    return make_sync_compressor(sync.compressor, sync.compress_ratio,
                                sync.quant_bits)


def build_cascade(sync: SyncConfig, tree=None) -> Tuple[CascadeLevel, ...]:
    """Resolve ``SyncConfig.levels`` against the (tree) topology preset:
    lambda from the compressor calculus, fanouts from the tree, periods
    nested (each a multiple of the level below)."""
    from repro_torch.comm.tree import get_tree_topology

    if not sync.levels:
        raise ValueError("build_cascade needs SyncConfig.levels")
    if tree is None:
        tree = get_tree_topology(sync.topology)
    if len(sync.levels) != len(tree.levels):
        raise ValueError(
            f"SyncConfig.levels has {len(sync.levels)} levels but tree "
            f"topology {tree.name!r} has {len(tree.levels)}")
    out, prev = [], None
    for lc, tl in zip(sync.levels, tree.levels):
        c = make_sync_compressor(lc.compressor, lc.compress_ratio,
                                 lc.quant_bits)
        if lc.period < 1:
            raise ValueError(f"level {lc.name!r}: period must be >= 1")
        if prev is not None and lc.period % prev != 0:
            raise ValueError(
                f"level {lc.name!r}: period {lc.period} is not a multiple of "
                f"the level below ({prev}); cascade periods must be nested")
        lam = (comp_lib.lambda_star(c.eta, c.omega)
               if c.eta is not None and c.omega is not None else 1.0)
        out.append(CascadeLevel(lc.name or tl.name, c, lam, lc.period,
                                tl.fanout))
        prev = lc.period
    return tuple(out)


def fused_path(c: Compressor, bucket_size: int) -> bool:
    return bool(bucket_size) and c.flatten


def sync_state_init(params, n_groups: int, sync: SyncConfig,
                    n_pods: int = 1) -> Optional[SyncState]:
    """Zero control variates; bucketed when ``efbv_sync`` will take the
    fused path for this config."""
    if sync.mode in ("dense",):
        return None
    if sync.mode == "hier":
        n_groups = n_pods  # control variates live at pod level
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device
    if sync.mode != "hier" and fused_path(build_compressor(sync), sync.bucket_size):
        layout = bk.bucket_layout(params, sync.bucket_size)
        shape = (layout.n_buckets, layout.bucket_size)
        return SyncState(
            h=torch.zeros((n_groups,) + shape, dtype=torch.float32, device=dev),
            h_bar=torch.zeros(shape, dtype=torch.float32, device=dev),
            step=0, layout=layout)
    zeros_g = tree_map(lambda p: torch.zeros((n_groups,) + tuple(p.shape),
                                             dtype=torch.float32, device=p.device),
                       params)
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return SyncState(h=zeros_g, h_bar=zeros, step=0)


def sync_state_trees(state: SyncState):
    """(h, h_bar) as trees (f32), whatever form the state holds them in."""
    if state.layout is None:
        return state.h, state.h_bar
    return (bk.debucketize_groups(state.h, state.layout, dtype=torch.float32),
            bk.debucketize(state.h_bar, state.layout, dtype=torch.float32))


def sync_params(sync: SyncConfig, n_groups: int) -> Tuple[float, float]:
    """(lambda, nu) for the configured mode/compressor."""
    c = build_compressor(sync)
    if sync.mode in ("efbv", "ef21", "diana", "hier"):
        mode = "efbv" if sync.mode == "hier" else sync.mode
        return comp_lib.lambda_star(c.eta, c.omega), (
            comp_lib.nu_star(c.eta, comp_lib.omega_ran_independent(c.omega, n_groups))
            if mode == "efbv" and not c.deterministic
            else comp_lib.lambda_star(c.eta, c.omega)
            if mode in ("efbv", "ef21")
            else 1.0
        )
    return 1.0, 1.0


# ---------------------------------------------------------------------------
# Compression of a bucketed (G, nb, B) delta
# ---------------------------------------------------------------------------
def _draw(noise, i):
    return None if noise is None else noise[i]


def _kernel_quant_bits(c: Compressor) -> Optional[int]:
    """Bits of a plain ``qsgd_kernel`` (kernel B1, row-local), else None."""
    w = c.wire
    if (c.flatten and w is not None and w.scheme == "quant"
            and w.axis == "kernel" and w.gain == 1.0):
        return w.bits
    return None


def _b1_rows_(row2d: torch.Tensor, d: int, bits: int, noise, generator) -> None:
    """B1 over the first ``tile_rows(d)`` rows of one group's (rows, 512)
    bucket view, in place, chunk by chunk.  ``noise`` is the whole call's
    (tile_rows(d), 512) draw or None (then each chunk draws from
    ``generator``)."""
    rows_pad = tile_rows(d)
    if noise is not None and tuple(noise.shape) != (rows_pad, quant8.QBLOCK):
        raise ValueError(f"noise shape {tuple(noise.shape)}, expected "
                         f"{(rows_pad, quant8.QBLOCK)}")
    for r0 in range(0, rows_pad, CHUNK_ROWS):
        r1 = min(rows_pad, r0 + CHUNK_ROWS)
        x2d = row2d[r0:r1]
        if noise is None:
            if generator is None:
                raise ValueError("stochastic rounding needs noise= or generator=")
            u = torch.rand((r1 - r0, quant8.QBLOCK), generator=generator,
                           dtype=torch.float32, device=x2d.device)
        else:
            u = noise[r0:r1].to(device=x2d.device, dtype=torch.float32).contiguous()
        x2d.copy_(quant8.quant_dequant_2d(x2d, u, bits=bits))
        del u


def fused_apply_(fn, delta_b: torch.Tensor, d: int) -> torch.Tensor:
    """Replace each group's true d-dim row of a bucketed (G, nb, B) delta by
    ``fn(i, row)`` in place; the zero-padded bucket tail stays zero, so
    size-dependent operators (top-k's k, rand-k's d/k) see the real d.
    Returns ``delta_b``."""
    flat = delta_b.view(delta_b.shape[0], -1)
    for i in range(flat.shape[0]):
        flat[i, :d] = fn(i, flat[i, :d])
    return delta_b


def fused_compress_(c: Compressor, delta_b: torch.Tensor, d: int,
                    noise=None, generator=None) -> torch.Tensor:
    """One compressor pass per group over the bucketed delta, in place.
    ``noise[i]`` is group i's draw for the d-dim vector."""
    bits = _kernel_quant_bits(c)
    G = delta_b.shape[0]
    padded = delta_b[0].numel()
    if (bits is not None and padded % quant8.QBLOCK == 0
            and padded >= tile_rows(d) * quant8.QBLOCK):
        for i in range(G):
            row2d = delta_b[i].view(-1, quant8.QBLOCK)
            _b1_rows_(row2d, d, bits, _draw(noise, i), generator)
            delta_b[i].view(-1)[d:].zero_()
        return delta_b
    return fused_apply_(lambda i, v: c(v, noise=_draw(noise, i), generator=generator),
                        delta_b, d)


# ---------------------------------------------------------------------------
# Sync transforms on per-group gradients (leading axis G)
# ---------------------------------------------------------------------------
def dense_sync(grads_g):
    """Plain mean over the group axis."""
    return tree_map(group_mean, grads_g)


def efbv_sync(grads_g, state: SyncState, c: Compressor, lam: float, nu: float,
              bucket_size: Optional[int] = None, noise=None, generator=None,
              like=None):
    """EF-BV over per-group gradients (a tree with leading axis G).
    Returns (g_est, state).

    Fused path (``bucket_size`` > 0, the default, and ``c.flatten``): the
    tree is bucketized and compressed in one pass per group over the whole
    d-dim vector; ``noise[i]`` is group i's draw.  Per-leaf path
    (``bucket_size=0`` or a ``flatten=False`` compressor): one compressor
    call per leaf per group, ``noise[li][i]``.  ``like`` (a tree) casts each
    leaf of ``g_est`` to its dtype as it is produced, equal to casting the
    f32 result afterwards.
    """
    if bucket_size is None:
        bucket_size = bk.DEFAULT_BUCKET_SIZE
    if not fused_path(c, bucket_size):
        return _efbv_sync_leaves(grads_g, state, c, lam, nu, noise,
                                 generator, like)
    with obs_trace.span("sync/bucketize"):
        g_b, layout = bk.bucketize_groups(grads_g, bucket_size)
    return efbv_sync_buckets(g_b, layout, state, c, lam, nu, noise=noise,
                             generator=generator, like=like)


def efbv_sync_buckets(g_b: torch.Tensor, layout: bk.BucketLayout,
                      state: SyncState, c: Compressor, lam: float, nu: float,
                      noise=None, generator=None, like=None):
    """The fused EF-BV update on an already bucketized (G, nb, B) f32
    gradient ``g_b``, which it consumes (it becomes the compressed delta).
    A tree-form ``state`` is bucketized first; the returned state is
    bucketed and updated in place."""
    if state.layout is None:
        h_b = bk.bucketize_groups(state.h, layout.bucket_size)[0]
        hb_b = bk.bucketize(state.h_bar, layout.bucket_size)[0]
    else:
        h_b, hb_b = state.h, state.h_bar
    with obs_trace.span("sync/compress"):
        d_i = fused_compress_(c, g_b.sub_(h_b), layout.d, noise, generator)
    d = group_mean(d_i)
    h_b.add_(d_i.mul_(lam))                          # h + lam * d_i
    del d_i, g_b
    with obs_trace.span("sync/debucketize"):
        g_est = _estimate_leaves(hb_b, d, nu, layout, like)
    hb_b.add_(d.mul_(lam))                           # h_bar + lam * d
    return g_est, SyncState(h=h_b, h_bar=hb_b, step=state.step + 1,
                            layout=layout)


def _estimate_leaves(hb_b, d, nu: float, layout: bk.BucketLayout, like):
    """h_bar + nu * d, leaf by leaf out of the bucket space, each leaf cast
    to ``like``'s dtype (f32 when ``like`` is None)."""
    hb, dd = hb_b.view(-1), d.view(-1)
    dtypes = (layout.dtypes if like is None
              else [bk.dtype_name(x.dtype) for x in tree_flatten(like)[0]])
    leaves = []
    for shape, size, off, dt in zip(layout.shapes, layout.sizes, layout.offsets, dtypes):
        est = hb[off: off + size] + nu * dd[off: off + size]
        leaves.append(est.view(shape).to(torch.float32 if like is None
                                          else bk.to_dtype(dt)))
    return tree_unflatten(layout.treedef, leaves)


def _efbv_sync_leaves(grads_g, state: SyncState, c: Compressor, lam: float,
                      nu: float, noise, generator, like):
    """Per-leaf EF-BV (one compressor call per leaf per group)."""
    if state.layout is not None:
        h, h_bar = sync_state_trees(state)
        state = SyncState(h=h, h_bar=h_bar, step=state.step)
    leaves, treedef = tree_flatten(grads_g)
    h_leaves = tree_flatten(state.h)[0]
    hb_leaves = tree_flatten(state.h_bar)[0]
    like_leaves = tree_flatten(like)[0] if like is not None else [None] * len(leaves)
    G = leaves[0].shape[0]
    g_est = []
    for li, (g, h, hb, lk) in enumerate(zip(leaves, h_leaves, hb_leaves, like_leaves)):
        delta = g.float() - h
        lnoise = _draw(noise, li)
        d_i = torch.stack([c(delta[i], noise=_draw(lnoise, i), generator=generator)
                           for i in range(G)])
        del delta
        d = group_mean(d_i)
        h.add_(d_i.mul_(lam))
        est = hb + nu * d
        g_est.append(est if lk is None else est.to(lk.dtype))
        hb.add_(d.mul_(lam))
    return (tree_unflatten(treedef, g_est),
            SyncState(h=state.h, h_bar=state.h_bar, step=state.step + 1))


# ---------------------------------------------------------------------------
# Anchor cascade (hier / local replicas)
# ---------------------------------------------------------------------------
def tree_sync_state_init(params, levels: Sequence[CascadeLevel]) -> TreeSyncState:
    """Anchors for every cascade level, all seeded from the shared params."""
    n = 1
    for lev in levels:
        n *= lev.fanout
    anchors = []
    for l, lev in enumerate(levels):
        n //= lev.fanout
        if l == len(levels) - 1:
            anchors.append(tree_map(lambda p: p.float().clone(), params))
        else:
            anchors.append(tree_map(
                lambda p, n=n: p.float()[None].expand((n,) + tuple(p.shape)).clone(),
                params))
    return TreeSyncState(anchors=tuple(anchors), step=0)


def _survivor_masks(survivors, levels):
    """Normalize per-level survivor masks (None = everyone made the round):
    ``survivors[l]`` masks level l's children; entries > 0 participated."""
    if survivors is None:
        return [None] * len(levels)
    survivors = tuple(survivors)
    if len(survivors) != len(levels):
        raise ValueError(f"{len(survivors)} survivor masks for "
                         f"{len(levels)} cascade levels")
    n = 1
    for lev in levels:
        n *= lev.fanout
    out = []
    for lev, m in zip(levels, survivors):
        if m is None:
            out.append(None)
        else:
            m = torch.as_tensor(m, dtype=torch.float32)
            if tuple(m.shape) != (n,):
                raise ValueError(
                    f"level {lev.name!r}: survivor mask shape {tuple(m.shape)}, "
                    f"expected ({n},)")
            out.append(m)
        n //= lev.fanout
    return out


def _survivor_weights(m: torch.Tensor, f: int) -> torch.Tensor:
    """Mean-preserving reweighting: ``w = m * (f / max(sum(m), 1))``, exactly
    1.0 under an all-ones mask; zero survivors give w == 0 (the anchor holds)."""
    # a true division: ``f / tensor`` in torch is ``f * reciprocal(tensor)``
    num = m.new_tensor(float(f))
    if m.dim() == 1:
        return m * (num / torch.clamp_min(m.sum(), 1.0))
    return m * (num / torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0))


def _wcol(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return w.reshape(tuple(w.shape) + (1,) * (ndim - w.dim()))


def _n_sync(step: int, levels) -> int:
    """Levels syncing at ``step``: nested periods make this a prefix."""
    return sum(1 for lev in levels if step % lev.period == lev.period - 1)


def tree_param_sync(params_g, state: TreeSyncState,
                    levels: Sequence[CascadeLevel],
                    bucket_size: Optional[int] = None, survivors=None,
                    leaf_compress=None, noise=None, generator=None):
    """Multi-level anchor cascade (Cohort-Squeeze beyond two levels).

    ``params_g``: tree with leading leaf axis G = prod(fanout_l), one
    training replica per tree leaf.  Every ``period[l]`` steps level l's
    children sync through a compressed EF21 delta against their parent
    anchor (``anchor += lam_l * mean_i C_l(child_i - anchor)``); then every
    node below the highest synced level adopts that ancestor's anchor.  Off-
    period steps do nothing (a Python branch on the host step counter).

    ``survivors`` (optional, from ``FaultModel.round_plan``): one mask per
    level over its children; non-survivors get zero weight in the anchor
    update and dropped leaves keep their local params.  ``leaf_compress``
    (fused path only) replaces level 0's compressor pass with a
    ``(delta_b, d, noise, generator) -> d_i`` callable.

    Draws: fused path ``noise[l][i]`` for child i of level l; per-leaf path
    ``noise[l][li][i]``.  Replica leaves are updated in place; returns
    (params_g, TreeSyncState).
    """
    if bucket_size is None:
        bucket_size = bk.DEFAULT_BUCKET_SIZE
    levels = tuple(levels)
    prev = None
    for lev in levels:
        if prev is not None and lev.period % prev != 0:
            raise ValueError(
                f"level {lev.name!r}: period {lev.period} not a multiple of "
                f"the level below ({prev}); cascade periods must be nested")
        prev = lev.period
    G = tree_flatten(params_g)[0][0].shape[0]
    n_expected = 1
    for lev in levels:
        n_expected *= lev.fanout
    if G != n_expected:
        raise ValueError(f"params_g has {G} leaves but cascade fanouts "
                         f"multiply to {n_expected}")
    fused = bool(bucket_size) and all(lev.compressor.flatten for lev in levels)
    if leaf_compress is not None and not fused:
        raise ValueError(
            "leaf_compress requires the fused (bucketized) path: set a "
            "bucket_size > 0 and use flatten=True level compressors")
    masks = _survivor_masks(survivors, levels)
    n_sync = _n_sync(state.step, levels)
    anchors = state.anchors
    if n_sync:
        if fused:
            params_g, anchors = _tree_sync_fused(
                params_g, anchors, levels, bucket_size, n_sync, masks,
                leaf_compress, noise, generator)
        else:
            params_g, anchors = _tree_sync_leaves(
                params_g, anchors, levels, n_sync, masks, noise, generator)
    return params_g, TreeSyncState(anchors=anchors, step=state.step + 1)


def _tree_sync_fused(params_g, anchors_in, levels, bucket_size, n_sync,
                     masks, leaf_compress, noise, generator):
    L = len(levels)
    p_b, layout = bk.bucketize_groups(params_g, bucket_size)     # (G, nb, B)
    G = p_b.shape[0]
    anchors = [bk.bucketize(a, bucket_size)[0] if l == L - 1
               else bk.bucketize_groups(a, bucket_size)[0]
               for l, a in enumerate(anchors_in)]

    def compress(l, delta_b):
        lnoise = _draw(noise, l)
        if l == 0 and leaf_compress is not None:
            return leaf_compress(delta_b, layout.d, lnoise, generator)
        return fused_compress_(levels[l].compressor, delta_b, layout.d,
                               lnoise, generator)

    def level_sync(l, child_b, parent_b):
        lev, m = levels[l], masks[l]
        with obs_trace.span(f"sync/level/{lev.name}"):
            if parent_b.dim() == 2:                  # root: unstacked anchor
                d_i = compress(l, child_b - parent_b)
                if m is not None:
                    d_i = d_i * _survivor_weights(m.to(d_i.device), d_i.shape[0])[:, None, None]
                return parent_b + lev.lam * group_mean(d_i)
            n_par = parent_b.shape[0]
            f = child_b.shape[0] // n_par
            d_i = compress(l, child_b - torch.repeat_interleave(parent_b, f, dim=0))
            d_g = d_i.reshape((n_par, f) + tuple(d_i.shape[1:]))
            if m is not None:
                w = _survivor_weights(m.to(d_g.device).reshape(n_par, f), f)
                d_g = d_g * w[:, :, None, None]
            return parent_b + lev.lam * group_mean(d_g, 1)

    child = p_b
    for l in range(n_sync):
        anchors[l] = level_sync(l, child, anchors[l])
        child = anchors[l] if anchors[l].dim() == 3 else anchors[l][None]
    top = anchors[n_sync - 1]
    top_s = top if top.dim() == 3 else top[None]
    for l in range(n_sync - 1):
        adopted = torch.repeat_interleave(top_s, anchors[l].shape[0] // top_s.shape[0], dim=0)
        if masks[l + 1] is not None:
            # groups whose uplink was dead carry their EF21 anchor
            adopted = torch.where(masks[l + 1].to(adopted.device)[:, None, None] > 0,
                                  adopted, anchors[l])
        anchors[l] = adopted
    p_out = torch.repeat_interleave(top_s, G // top_s.shape[0], dim=0)
    if masks[0] is not None:
        # dropped leaves keep their local params this round
        p_out = torch.where(masks[0].to(p_out.device)[:, None, None] > 0, p_out, p_b)
    new_anchors = tuple(
        bk.debucketize(anchors[l], layout, dtype=torch.float32) if l == L - 1
        else bk.debucketize_groups(anchors[l], layout, dtype=torch.float32)
        for l in range(L))
    new_p = bk.debucketize_groups(p_out, layout)
    for dst, src in zip(tree_flatten(params_g)[0], tree_flatten(new_p)[0]):
        dst.copy_(src)
    return params_g, new_anchors


def _tree_sync_leaves(params_g, anchors_in, levels, n_sync, masks, noise, generator):
    """Per-leaf cascade (one compressor call per leaf per level per child)."""
    L = len(levels)
    leaves = tree_flatten(params_g)[0]
    treedefs = [tree_flatten(a)[1] for a in anchors_in]
    anchors = [list(tree_flatten(a)[0]) for a in anchors_in]

    def level_sync(l, li, child, parent):
        lev, m = levels[l], masks[l]
        lnoise = _draw(_draw(noise, l), li)
        with obs_trace.span(f"sync/level/{lev.name}"):
            delta = child.float()
            if parent.dim() == child.dim():           # stacked (non-root) anchor
                n_par = parent.shape[0]
                f = child.shape[0] // n_par
                delta = delta - torch.repeat_interleave(parent, f, dim=0)
                d_i = torch.stack([lev.compressor(delta[i], noise=_draw(lnoise, i),
                                                  generator=generator)
                                   for i in range(delta.shape[0])])
                del delta
                d_g = d_i.reshape((n_par, f) + tuple(d_i.shape[1:]))
                if m is not None:
                    w = _survivor_weights(m.to(d_g.device).reshape(n_par, f), f)
                    d_g = d_g * _wcol(w, d_g.dim())
                return parent + lev.lam * group_mean(d_g, 1)
            delta = delta - parent
            d_i = torch.stack([lev.compressor(delta[i], noise=_draw(lnoise, i),
                                              generator=generator)
                               for i in range(delta.shape[0])])
            del delta
            if m is not None:
                d_i = d_i * _wcol(_survivor_weights(m.to(d_i.device), d_i.shape[0]),
                                  d_i.dim())
            return parent + lev.lam * group_mean(d_i)

    for li, p in enumerate(leaves):
        child = p
        for l in range(n_sync):
            anchors[l][li] = level_sync(l, li, child, anchors[l][li])
            a = anchors[l][li]
            child = a if a.dim() == p.dim() else a[None]
        top = anchors[n_sync - 1][li]
        top_s = top if top.dim() == p.dim() else top[None]
        for l in range(n_sync - 1):
            reps = anchors[l][li].shape[0] // top_s.shape[0]
            adopted_a = torch.repeat_interleave(top_s, reps, dim=0)
            if masks[l + 1] is not None:
                # dead-uplink groups carry their EF21 anchor
                adopted_a = torch.where(
                    _wcol(masks[l + 1].to(p.device), adopted_a.dim()) > 0,
                    adopted_a, anchors[l][li])
            anchors[l][li] = adopted_a
        top_p = top_s.to(p.dtype)
        if top_s.shape[0] > 1:
            adopted = torch.repeat_interleave(top_p, p.shape[0] // top_s.shape[0], dim=0)
        else:
            adopted = top_p.expand(p.shape)
        if masks[0] is not None:
            # dropped leaves keep their local params this round
            adopted = torch.where(_wcol(masks[0].to(p.device), p.dim()) > 0, adopted, p)
        p.copy_(adopted)
        del adopted, top_p
    new_anchors = tuple(tree_unflatten(td, a) for td, a in zip(treedefs, anchors))
    return params_g, new_anchors


def hier_param_sync(params_g, state: SyncState, c: Compressor, lam: float,
                    period: int, bucket_size: Optional[int] = None,
                    survivors=None, noise=None, generator=None):
    """Cohort-Squeeze / local training (param-level EF21 sync): every
    ``period`` steps, ``h_bar += lam * mean_i C(params_i - h_bar)`` and
    every group adopts ``h_bar``.  The depth-1 case of ``tree_param_sync``;
    ``noise`` is that level's draws (``noise[i]`` fused, ``noise[li][i]``
    per leaf)."""
    G = tree_flatten(params_g)[0][0].shape[0]
    lev = CascadeLevel("inter", c, lam, int(period), G)
    tstate = TreeSyncState(anchors=(state.h_bar,), step=state.step)
    if survivors is not None and not isinstance(survivors, (tuple, list)):
        survivors = (survivors,)  # single group-axis mask
    new_p, ts = tree_param_sync(params_g, tstate, (lev,), bucket_size=bucket_size,
                                survivors=survivors,
                                noise=None if noise is None else (noise,),
                                generator=generator)
    return new_p, SyncState(h=state.h, h_bar=ts.anchors[0], step=ts.step)


# ---------------------------------------------------------------------------
# Bits accounting (per communication round, per worker)
# ---------------------------------------------------------------------------
def bits_per_round(sync: SyncConfig, n_params: int, device=None) -> float:
    """Measured per-round payload bits (``comm.accounting.round_bits``)."""
    from repro_torch.comm import round_bits

    return round_bits(sync, n_params, device=device)


def round_comm(sync: SyncConfig, n_params: int, topology=None, device=None):
    """Full per-round communication report (``comm.accounting.round_cost``):
    encoded bytes per link class and the modelled time on the preset."""
    from repro_torch.comm import round_cost

    return round_cost(sync, n_params, topology=topology, device=device)
