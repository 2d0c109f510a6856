"""Sharding rules engine: param-path patterns -> per-dimension specs (port of
``repro/sharding/rules.py``).

The production mesh is (data=16, model=16) single-pod or (pod=2, data=16,
model=16) multi-pod.  Rules follow Megatron-style tensor parallelism on the
``model`` axis (FFN hidden, attention projections, vocab, MoE expert axis)
with batch data-parallel over (pod, data).  A divisibility check drops an
axis when the dimension is smaller than the mesh axis (e.g. batch=1 decode)
or does not divide by it.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry per
tensor dimension: ``None`` (replicated), an axis name, or a tuple of names
(the dimension is split over those mesh axes, the first one major),
normalized as ``PartitionSpec`` normalizes (``spec``): a one-name tuple is
the name, an empty one ``None``.
``placements(spec, mesh)`` turns it into DTensor ``Shard`` / ``Replicate``
placements, one per mesh dimension.  The rules read only the mesh's axis
sizes and names: a ``torch.distributed.device_mesh.DeviceMesh``, or any
object with a ``shape`` mapping of axis -> size and ``axis_names`` (the
reference's tests pass a ``SimpleNamespace``).

Every rule is a (path regex, spec-for-trailing-dims) pair; leading stack dims
added by the layer loop (n_periods) or by local-training replicas are
handled by prepending.  Paths join a param tree's dict keys with '/', as the
reference's ``_path_str`` joins its ``DictKey``s.
"""
from __future__ import annotations

import re
from typing import Optional


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


# data-parallel axes: ("pod", "data") on the multi-pod mesh, ("data",) else
def data_axes(mesh):
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


DATA_AXES = data_axes  # alias


# Variant: disable tensor parallelism entirely (small models: TP all-reduces
# of activation cotangents dwarf the weights; pure FSDP wins)
NO_TP = False

# (regex on '/'-joined path, trailing-dims partition tuple), the reference's
# table verbatim
_PARAM_RULES = [
    # embedding table sharded on the FEATURE dim: a gather whose rows are
    # unsharded partitions trivially (each model shard gathers its d-slice);
    # vocab-sharded tables trip GSPMD's gather partitioning inside scan+remat
    (r"embed/tok$", (None, "model")),
    (r"embed/unembed$", (None, "model")),
    (r"(attn|xattn)/wq$", (None, "model")),
    (r"(attn|xattn)/wk$", (None, "model")),
    (r"(attn|xattn)/wv$", (None, "model")),
    (r"(attn|xattn)/wo$", ("model", None)),
    (r"(attn|xattn)/b[qkv]$", ("model",)),
    (r"(mlp|shared)/w_(in|gate)$", (None, "model")),
    (r"(mlp|shared)/w_out$", ("model", None)),
    (r"moe/router$", (None, None)),
    (r"moe/w_(in|gate)$", ("model", None, None)),   # expert parallel
    (r"moe/w_out$", ("model", None, None)),
    (r"mamba/in_proj$", (None, "model")),
    (r"mamba/conv_[wb]$", (None,)),                  # small; replicate
    (r"mamba/(a_log|dt_bias|D)$", (None,)),
    (r"mamba/out_proj$", ("model", None)),
    (r"vision_proj$", (None, "model")),
    (r"norm", (None,)),
    (r"(final_norm|norm1|norm2|norm_x)/scale$", (None,)),
]


def spec(*entries) -> tuple:
    """A spec tuple, each entry normalized as ``PartitionSpec`` does."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _map_with_path(fn, tree, path=()):
    """``fn('/'-joined path, leaf)`` over a tree of dicts, lists and tuples
    (``None`` an empty subtree), as ``jax.tree_util.tree_map_with_path``
    with the reference's ``_path_str``: a dict key as ``str(key)``, a
    sequence index as ``[i]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn("/".join(path), tree)


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, with ``specs`` (a spec tree: its
    leaves are tuples) flattened up to ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_specs(fn, v, s) for v, s in zip(tree, specs)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, specs)


def _axis_size(axis, sizes: dict) -> int:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[a]
    return size


def maybe_axis(dim: int, axis: Optional[str], mesh):
    """Drop the axis unless the dim divides evenly over the mesh axis
    (uneven partitions are refused, e.g. vocab 50280 on 16)."""
    if axis is None:
        return None
    size = _axis_size(axis, mesh_sizes(mesh))
    return axis if (dim >= size and dim % size == 0) else None


def _spec_for(path_s: str, shape, mesh, extra_leading: int = 0) -> tuple:
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, path_s):
            if NO_TP:
                trailing = tuple(None if t == "model" else t for t in trailing)
            nt = len(trailing)
            # conv_b / scalars: trailing rule may be longer than shape
            trailing = trailing[-min(nt, len(shape) - extra_leading):]
            lead = (None,) * (len(shape) - len(trailing))
            return spec(*lead, *[maybe_axis(shape[len(lead) + i], ax, mesh)
                                 for i, ax in enumerate(trailing)])
    return spec(*([None] * len(shape)))


def param_specs(params, mesh, extra_leading: int = 0, replica_axes=None,
                fsdp_axes=None, fsdp_min_dim: int = 1024):
    """Spec tree for a param tree (``meta`` or real tensors: only shapes are
    read).

    ``extra_leading`` dims (layer stacks) stay unsharded unless
    ``replica_axes`` names the mesh axes for the outermost leading dim
    (local-training per-group replicas).

    ``fsdp_axes`` additionally shards the first large unsharded dim of every
    weight over the given data axes (ZeRO-3 / FSDP): required for the >30B
    archs where tensor-parallel-only params exceed one device's memory."""
    sizes = mesh_sizes(mesh)

    def one(ps, leaf):
        shape = tuple(leaf.shape)
        out = list(_spec_for(ps, shape, mesh, extra_leading))
        if replica_axes is not None:
            out[0] = replica_axes
        # embedding tables stay vocab-sharded only: FSDP over the feature dim
        # trips the reference's SPMD partitioner on the gather, and the
        # tables are small next to the FFN stack
        if fsdp_axes and "embed" not in ps:
            size = _axis_size(fsdp_axes, sizes)
            start = 1 if replica_axes is not None else 0
            for i in range(start, len(out)):
                dim = shape[i]
                if out[i] is None and dim % size == 0 and dim >= fsdp_min_dim:
                    out[i] = fsdp_axes
                    break
        return spec(*out)

    return _map_with_path(one, params)


def opt_state_specs(params, pspecs, mesh, zero1: bool = True):
    """Specs for AdamW moments: same as the param, plus ZeRO-1 style extra
    sharding of the largest unsharded dim over the data axes (moments are
    f32 and dominate state memory on the big archs)."""
    daxes = data_axes(mesh)
    dsize = _axis_size(daxes, mesh_sizes(mesh))

    def one(p, ps):
        ps = tuple(ps)
        if not zero1:
            return spec(*ps)
        best, best_dim = None, 0
        for i, (ax, dim) in enumerate(zip(ps, p.shape)):
            if ax is None and dim % dsize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return spec(*ps)
        new = list(ps)
        new[best] = daxes if len(daxes) > 1 else daxes[0]
        return spec(*new)

    return map_with_specs(one, params, pspecs)


def batch_specs(batch_shapes: dict, mesh, group_stacked: bool = False, axes=None):
    """Specs for input batches: leading batch dim over (pod, data), or over
    ALL axes (incl. 'model') in NO_TP mode, where every device is a pure
    data-parallel worker."""
    daxes = axes if axes is not None else data_axes(mesh)
    if axes is None and NO_TP:
        daxes = daxes + ("model",)
    ax = daxes if len(daxes) > 1 else daxes[0]

    def one(_, leaf):
        if leaf.ndim == 0:
            return ()
        return spec(maybe_axis(leaf.shape[0], ax, mesh), *([None] * (leaf.ndim - 1)))

    return _map_with_path(one, batch_shapes)


def cache_pspecs(cache_shapes, mesh):
    """Decode-cache specs.  Leaves are stacked (n_periods, B, S, ...) for
    attention K/V, (n_periods, B, H, hd, N) / (n_periods, B, K-1, conv) for
    SSD, plus scalars and the enc memory (B, S, D).

    Batch shards over (pod, data) when divisible; the attention cache's
    sequence shards over 'model' (long-context flash-decoding style), and
    the SSD head / channel dims over 'model'."""
    daxes = data_axes(mesh)
    bax = daxes if len(daxes) > 1 else daxes[0]

    def one(ps, leaf):
        if leaf.ndim == 0:
            return ()
        if ps.endswith("enc_memory"):
            b = maybe_axis(leaf.shape[0], bax, mesh)
            return spec(b, None, maybe_axis(leaf.shape[2], "model", mesh))
        if re.search(r"/(k|v)$", ps):
            # (n_periods, B, S, KV, hd)
            _, B, S, KV, hd = leaf.shape
            return spec(None, maybe_axis(B, bax, mesh), maybe_axis(S, "model", mesh), None,
                        None)
        if ps.endswith("ssm"):
            _, B, H, hd, N = leaf.shape
            return spec(None, maybe_axis(B, bax, mesh), maybe_axis(H, "model", mesh), None,
                        None)
        if ps.endswith("conv"):
            _, B, K, C = leaf.shape
            return spec(None, maybe_axis(B, bax, mesh), None, maybe_axis(C, "model", mesh))
        return spec(*([None] * leaf.ndim))

    return _map_with_path(one, cache_shapes)


def placements(ps: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(i)`` on every mesh axis that tensor dim i is split over (a dim
    over ("pod", "data") gets ``Shard(i)`` on both), ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axis_names(mesh):
        dims = [i for i, ax in enumerate(ps)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        if len(dims) > 1:
            raise ValueError(f"spec {ps} splits dims {dims} over mesh axis {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
