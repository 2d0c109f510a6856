"""Where a DTensor's dims lie on a launcher's mesh, for the model's
``local_map`` regions and the per-rank train steps: the placements of an
activation (batch over the data axes, one dim over "model"), of its
gradient, a rank's offset into a sharded dim, and the sub-mesh and process
group of a set of mesh axes.  The model layer asks these helpers and names
no mesh axis itself.

``isinstance(x, AnyDTensor)`` is the plain path's only contact with
DTensor: it imports nothing (``torch.distributed.tensor`` pulls in some 500
modules, about a second, and no DTensor exists before it is imported).
"""
from __future__ import annotations

import sys
from typing import Optional

from repro_torch.sharding.rules import data_axes, maybe_axis, mesh_axis_names, mesh_sizes

MODEL = "model"     # the tensor-parallel axis of the rules


class _DTensorCheck(type):
    def __instancecheck__(cls, x) -> bool:
        mod = sys.modules.get("torch.distributed.tensor")
        return mod is not None and isinstance(x, mod.DTensor)


class AnyDTensor(metaclass=_DTensorCheck):
    """``isinstance(x, AnyDTensor)`` is ``isinstance(x, DTensor)``, without
    importing DTensor."""


def divides(dim: int, axes, mesh) -> bool:
    """Whether ``dim`` splits evenly over those of the mesh axes ``axes`` (a
    name or a tuple) that the mesh has: the rules' divisibility test."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in (axes if isinstance(axes, tuple) else (axes,)) if a in sizes)
    return maybe_axis(dim, axes, mesh) is not None


def model_size(mesh) -> int:
    return mesh_sizes(mesh).get(MODEL, 1)


def model_coordinate(mesh) -> int:
    """This rank's index on the "model" axis (0 on a mesh without one)."""
    names = mesh_axis_names(mesh)
    return mesh.get_coordinate()[names.index(MODEL)] if MODEL in names else 0


def local_placements(mesh, batch: Optional[int] = None, *, model_dim: Optional[int] = None,
                     partial_model: bool = False, partial_batch: bool = False) -> list:
    """Placements, one per mesh axis, of a tensor whose dim 0 is a batch of
    ``batch`` (``None``: no batch dim): on the data axes ``Shard(0)`` where
    the batch divides over them all (``Partial()`` instead with
    ``partial_batch``: a gradient summed over the batch shards); on "model"
    ``Shard(model_dim)`` when given, else ``Partial()`` with
    ``partial_model``; ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    daxes = data_axes(mesh)
    bat = batch is not None and bool(daxes) and divides(batch, daxes, mesh)
    out = []
    for a in mesh_axis_names(mesh):
        if a in daxes and bat:
            out.append(Partial() if partial_batch else Shard(0))
        elif a == MODEL and model_dim is not None:
            out.append(Shard(model_dim))
        elif a == MODEL and partial_model:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def shard_start(mesh, placements, dim: int, size: int) -> int:
    """This rank's first index along ``dim`` (of global length ``size``) of
    a DTensor laid out by ``placements`` on ``mesh`` (even shards, mesh
    dims major first, as DTensor nests them)."""
    coord, start = mesh.get_coordinate(), 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            start += coord[i] * size
    return start


def group_axes(mesh, sync_mode: str) -> tuple:
    """The mesh axes a per-rank train step's groups (replicas) lie on, as
    the reference's dry-run maps them: "pod" for hier, the data axes for
    the efbv family and local."""
    return ("pod",) if sync_mode == "hier" else data_axes(mesh)


def group_index(mesh, axes: tuple) -> int:
    """This rank's index among the groups the mesh axes ``axes`` form (its
    coordinates on them, the first axis major: the order in which a dim
    sharded over ``axes`` nests its shards)."""
    names, coord, i = mesh.mesh_dim_names, mesh.get_coordinate(), 0
    for a in axes:
        i = i * mesh.size(names.index(a)) + coord[names.index(a)]
    return i


def sub_mesh(mesh, drop: tuple):
    """The ``DeviceMesh`` of ``mesh``'s axes other than ``drop``, through
    this rank."""
    keep = tuple(a for a in mesh.mesh_dim_names if a not in drop)
    return mesh[keep if len(keep) > 1 else keep[0]]


def process_group(mesh, axes: tuple):
    """The process group of the mesh axes ``axes`` (flattened when two;
    the mesh's bookkeeping runs on real tensors, also under the dry-run's
    ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    with unset_fake_temporarily():
        return mesh[tuple(axes)]._flatten().get_group()
