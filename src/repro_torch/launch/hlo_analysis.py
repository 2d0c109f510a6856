"""Roofline terms of a traced step (port of ``repro/launch/hlo_analysis.py``).

The reference reads XLA's artifacts: ``compiled.cost_analysis()`` for flops
and bytes, and the post-SPMD HLO text for the collectives.  The port has no
compiler, so it reads the step itself as the dry-run traces it (under
``FakeTensorMode``, on DTensors over a ``fake`` process group):

* ``CostCounter`` is a ``FakeTensorMode`` that also counts every op it runs
  on a rank's local tensors: the ops of DTensor's local dispatch, of
  ``local_map`` regions and of plain tensors.  An op on DTensors sees global
  shapes and is not counted; its local ops are (counted per rank, as XLA's
  post-SPMD ``cost_analysis`` is per device), and so are none of DTensor's
  sharding-propagation ops (global fake tensors, no rank's work).
* **flops** are ``torch.utils.flop_counter``'s formulas (its
  ``flop_registry``, the counts ``FlopCounterMode`` gives) on those local
  ops.
* **bytes** are the sum of each local op's input and output bytes (views,
  metadata queries and collectives left out): an unfused upper bound, not
  XLA's "bytes accessed", which counts a fusion's operands once.
* the **collectives** are the c10d and functional collectives the step
  issues on its local tensors: kind, result bytes, group size, and whether
  the group's ranks lie on both sides of the pod boundary (ranks below and
  at or above 256 on the (2, 16, 16) mesh; ``_crosses_pod``'s counterpart).
  Each one's payload follows the reference's per-kind rules
  (``payload_bytes``).

``memory_dict`` maps a dry-run record's ``memory`` onto the reference's
keys.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable

POD_SIZE = 256          # ranks per pod on the (2, 16, 16) mesh

# op name (namespace.name) -> the reference's HLO collective kind
_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-broadcast",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-broadcast",
}
_SKIP_BYTES = ("c10d.", "_c10d_functional", "prim.")      # wait_tensor, device


def payload_bytes(kind: str, rbytes: float, g: int) -> float:
    """The reference's per-device payload of one collective from its result
    bytes and group size (``hlo_analysis.py:99-109``)."""
    if kind == "all-reduce":
        return rbytes
    if kind == "all-gather":
        return rbytes / max(g, 1)
    if kind == "reduce-scatter":
        return rbytes * (g - 1) / max(g, 1) if g > 1 else rbytes
    if kind == "all-to-all":
        return rbytes * (g - 1) / max(g, 1)
    return rbytes                       # collective-permute (and broadcast)


def crosses_pod(ranks: Iterable[int], pod_size: int = POD_SIZE) -> bool:
    """Whether a group's global ranks lie on both sides of ``pod_size``."""
    ranks = list(ranks)
    return bool(ranks) and min(ranks) < pod_size <= max(ranks)


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    count_by_kind: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    inter_pod_bytes: float = 0.0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, rbytes: float, g: int, crosses: bool) -> None:
        payload = payload_bytes(kind, rbytes, g)
        self.bytes_by_kind[kind] += payload
        self.count_by_kind[kind] += 1
        if crosses:
            self.inter_pod_bytes += payload

    def as_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "inter_pod_bytes": float(self.inter_pod_bytes),
            "by_kind": {k: float(v) for k, v in self.bytes_by_kind.items()},
            "counts": dict(self.count_by_kind),
        }


def collective_bytes(records) -> CollectiveStats:
    """``CollectiveStats`` of collective records ``(kind, result_bytes,
    ranks)`` (the group's global ranks), in the order the step issued them."""
    stats = CollectiveStats()
    for kind, rbytes, ranks in records:
        ranks = list(ranks)
        stats.add(kind, rbytes, len(ranks), crosses_pod(ranks))
    return stats


def _op_name(func) -> str:
    schema = func._schema.name            # "namespace::name"
    return schema.replace("::", ".")


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_ranks(args, kwargs) -> list:
    """The global ranks of the process group a collective op names (a group
    name string for the functional ops, a ``ProcessGroup`` for c10d's)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    name = [a for a in args if isinstance(a, str)][-1]     # the functional ops' last str
    return dist.get_process_group_ranks(_resolve_process_group(name))


class CostCounter:
    """Flops, bytes and collectives of the local ops a traced step runs
    (the module docstring).  ``mode(**kw)`` makes the counting
    ``FakeTensorMode``; ``paused`` (a callable) tells it when ops run for
    DTensor's sharding propagation."""

    def __init__(self, paused=lambda: False, pod_size: int = POD_SIZE):
        self.flops = 0
        self.bytes = 0
        self.stats = CollectiveStats()
        self.paused = paused
        self.pod_size = pod_size

    def count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        name = _op_name(func)
        kind = _KINDS.get(name)
        if kind is not None:
            # the in-place c10d ops write their result into their first argument
            res = args[0] if name.startswith("c10d.") else out
            ranks = _group_ranks(args, kwargs)
            self.stats.add(kind, _nbytes(res), len(ranks), crosses_pod(ranks, self.pod_size))
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not (func.is_view or name.startswith(_SKIP_BYTES)):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)

    def mode(self, **kw):
        """A ``FakeTensorMode`` that counts the ops it runs on local tensors
        (depth 0 only: an op it runs inside another, a decomposition, is
        that op's own work)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        counter = self

        class CountingFakeTensorMode(FakeTensorMode):
            _cost_depth = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if (self._cost_depth or counter.paused()
                        or any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs)))):
                    return super().__torch_dispatch__(func, types, args, kwargs)
                self._cost_depth += 1
                try:
                    out = super().__torch_dispatch__(func, types, args, kwargs)
                finally:
                    self._cost_depth -= 1
                if out is not NotImplemented:
                    counter.count(func, args, kwargs, out)
                return out

        return CountingFakeTensorMode(**kw)

    def cost_dict(self) -> dict:
        """The counterpart of XLA's ``cost_analysis``: flops and the unfused
        bytes bound, per rank."""
        return {"flops": float(self.flops), "bytes unfused": float(self.bytes)}


def cost_dict(rec: dict) -> dict:
    """A traced record's (``dryrun.trace_step(..., cost=True)``) cost: flops
    and the unfused bytes bound, per rank."""
    return dict(rec["cost"])


def memory_dict(rec: dict) -> dict:
    """A dry-run record's ``memory`` under the reference's
    ``memory_analysis`` keys (the port has no generated code and no
    aliasing: those keys are 0)."""
    mem = rec["memory"]
    return {"generated_code_size_in_bytes": 0,
            "argument_size_in_bytes": int(mem["argument_size_in_bytes"]),
            "output_size_in_bytes": int(mem["output_size_in_bytes"]),
            "alias_size_in_bytes": 0,
            "temp_size_in_bytes": int(mem["temp_size_in_bytes"])}
