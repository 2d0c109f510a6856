"""Placement hooks installed by a launcher (port of
``repro/sharding/context.py``).

The step factories (``training/steps.py``) and the models are mesh-agnostic;
a launcher that runs them over a ``DeviceMesh`` installs specs here, and the
constraint points redistribute DTensors to them:

  * gradients: FSDP's backward leaves a weight's gradient as the matmul
    left it; constraining it to the param's placements turns that into the
    reduce-scatter + sharded-update pattern (ZeRO).
  * named points (``constrain_named``: the SSD head sharding) and the MoE
    dispatch's token / expanded / buffer tensors (``constrain_moe``).

Specs are ``sharding.rules``' per-dimension tuples.  With nothing installed,
or on a plain (non-DTensor) tensor, every constraint returns its input:
one device holds the whole tensor, which is every placement at once.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.sharding.rules import map_with_specs, mesh_sizes, placements

_GRAD_SPECS = None          # (specs tree, mesh)
_MOE_SPECS = None
_NAMED_SPECS: dict = {}     # name -> (spec, mesh)


def _redistribute(x, spec, mesh):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def set_grad_specs(specs, mesh=None) -> None:
    """Install the param spec tree (``rules.param_specs``) that gradients
    take on ``mesh``; ``None`` removes it."""
    global _GRAD_SPECS
    if specs is not None and mesh is None:
        raise ValueError("set_grad_specs: specs need the mesh they refer to")
    _GRAD_SPECS = None if specs is None else (specs, mesh)


def constrain_grads(grads):
    """Each DTensor gradient redistributed to its param's placements under
    installed specs; ``grads`` itself without them."""
    if _GRAD_SPECS is None:
        return grads
    specs, mesh = _GRAD_SPECS
    return map_with_specs(lambda g, s: _redistribute(g, s, mesh), grads, specs)


def set_moe_specs(specs: Optional[dict]) -> None:
    """{'impl': 'shardmap' | 'alltoall' | 'scatter', 'mesh': DeviceMesh,
    'data_axes': tuple, plus optional 'tokens' / 'expanded' / 'buf' specs
    for the scatter path}.  Installed by a launcher; None disables (tests,
    one device)."""
    global _MOE_SPECS
    _MOE_SPECS = specs


def get_moe_specs() -> Optional[dict]:
    return _MOE_SPECS


def set_named_specs(specs: Optional[dict], mesh=None) -> None:
    """{name: spec} for ``constrain_named`` on ``mesh``; None clears."""
    global _NAMED_SPECS
    if specs and mesh is None:
        raise ValueError("set_named_specs: specs need the mesh they refer to")
    _NAMED_SPECS = {k: (s, mesh) for k, s in (specs or {}).items()}


def constrain_named(name: str, x):
    got = _NAMED_SPECS.get(name)
    if got is None:
        return x
    return _redistribute(x, *got)


def moe_spec(name: str, shape) -> Optional[tuple]:
    """The installed MoE spec ``name`` fitted to ``shape``: an axis stays
    only where the dim divides evenly over it (and is at least its size),
    trailing dims replicated; None when nothing is installed for ``name``."""
    if not _MOE_SPECS or name not in _MOE_SPECS:
        return None
    spec = tuple(_MOE_SPECS[name])
    sizes = mesh_sizes(_MOE_SPECS["mesh"])

    def ok(dim, ax):
        if ax is None:
            return None
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= sizes.get(a, 10**9)
        return ax if (dim % size == 0 and dim >= size) else None

    return tuple(ok(d, a) for d, a in zip(shape, spec + (None,) * len(shape)))


def constrain_moe(name: str, x):
    spec = moe_spec(name, tuple(x.shape))
    if spec is None:
        return x
    return _redistribute(x, spec, _MOE_SPECS["mesh"])


# Variant switch read by launchers when installing MoE specs
_MOE_GATHER_QUANT = False


def set_moe_gather_quant(v: bool) -> None:
    global _MOE_GATHER_QUANT
    _MOE_GATHER_QUANT = bool(v)


def get_moe_gather_quant() -> bool:
    return _MOE_GATHER_QUANT


_MOE_IMPL_OVERRIDE = None


def set_moe_impl_override(v) -> None:
    global _MOE_IMPL_OVERRIDE
    _MOE_IMPL_OVERRIDE = v


def get_moe_impl_override():
    return _MOE_IMPL_OVERRIDE

