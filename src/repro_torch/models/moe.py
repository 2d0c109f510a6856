"""Token-choice Mixture-of-Experts with capacity-based dispatch (port of
``repro/models/moe.py:40-122``).

The router runs in f32: softmax, then top-k, the k gates renormalized, and
the Switch load-balance aux loss.  Each (token, k) assignment gets its rank
within its expert from a stable sort plus ``searchsorted``; ranks at or above
the capacity C are dropped into a trash slot.  The dispatch writes each kept
assignment into its own slot of an (E * C, d) buffer, the experts run as one
batched matmul, and the combine sums each token's K contributions in k order
in the model dtype, as the reference's scatter does: no atomics, so a run on
the card repeats itself bit for bit.

The dispatcher reads the MoE specs a launcher installed
(``sharding.context.set_moe_specs``), as the reference's does; without any,
the scatter path runs, its tensors passing through ``constrain_moe`` at the
reference's points.  The expert-parallel paths (``moe_ffn_alltoall``,
``moe_ffn_shardmap``) over a device mesh are not ported yet; they raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, init_mlp, mlp
from repro_torch.sharding import layout
from repro_torch.sharding.context import constrain_moe, get_moe_specs
from repro_torch.sharding.layout import AnyDTensor

MESH_TODO = ("expert-parallel MoE over a device mesh is not ported "
             "(ROADMAP.md Queue 1, item 8: multi-GPU, part 8d)")


def moe_apply(params: dict, x: torch.Tensor, specs: Optional[dict] = None,
              **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: ``specs`` (default: what a launcher installed with
    ``sharding.context.set_moe_specs``, ``{"impl": "alltoall" | "shardmap",
    "mesh": ..., ...}``) picks an expert-parallel path; without one, the
    single-device scatter path."""
    if specs is None:
        specs = get_moe_specs()
    if specs and specs.get("impl") == "alltoall":
        return moe_ffn_alltoall(params, x, **kw)
    if specs and specs.get("impl") == "shardmap":
        return moe_ffn_shardmap(params, x, **kw)
    return moe_ffn(params, x, **kw)


def moe_ffn_alltoall(params: dict, x: torch.Tensor, **kw):
    raise NotImplementedError(f"moe_ffn_alltoall: {MESH_TODO}")


def moe_ffn_shardmap(params: dict, x: torch.Tensor, **kw):
    raise NotImplementedError(f"moe_ffn_shardmap: {MESH_TODO}")


def init_moe(gen, d_model: int, d_ff: int, num_experts: int, gated: bool,
             shared_expert: bool, dtype, device, lead=()) -> dict:
    E = num_experts
    p = {"router": _dense_init(gen, (d_model, E), torch.float32, device, scale=0.02,
                               lead=lead),
         "w_in": _dense_init(gen, (E, d_model, d_ff), dtype, device, lead=lead),
         "w_out": _dense_init(gen, (E, d_ff, d_model), dtype, device, lead=lead)}
    if gated:
        p["w_gate"] = _dense_init(gen, (E, d_model, d_ff), dtype, device, lead=lead)
    if shared_expert:
        p["shared"] = init_mlp(gen, d_model, d_ff, gated, dtype, device, lead)
    return p


def _expert_ffn(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d), batched over the experts.  As the
    reference: gated experts take silu for "silu", else gelu; ungated ones
    squared ReLU for "relu2", else silu."""
    h = torch.bmm(x, p["w_in"])
    if gated:
        g = torch.bmm(x, p["w_gate"])
        h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * h
    else:
        h = torch.square(F.relu(h)) if act == "relu2" else F.silu(h)
    return torch.bmm(h, p["w_out"])


@dataclass
class Routing:
    """One MoE call's routing: per (token, k) assignment, flattened
    token-major (row ``t * K + k``)."""
    probs: torch.Tensor       # (T, E) f32 router softmax
    gate_w: torch.Tensor      # (T, K) f32 renormalized gates
    gate_i: torch.Tensor      # (T, K) expert of each assignment
    rank: torch.Tensor        # (T*K,) rank within its expert, in token order
    keep: torch.Tensor        # (T*K,) rank < capacity
    capacity: int

    @property
    def dropped(self) -> int:
        return int((~self.keep).sum())


def route(router: torch.Tensor, xt: torch.Tensor, num_experts: int, top_k: int,
          capacity_factor: float, no_drop: bool = False) -> Routing:
    """Route tokens ``xt`` (T, d): f32 logits, softmax, top-k, renormalized
    gates; capacity ``C = max(1, int(T*K*cf/E))`` (``T`` with ``no_drop``)
    and each assignment's rank within its expert (stable sort +
    ``searchsorted``)."""
    T, E, K = xt.shape[0], num_experts, top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_w, gate_i = torch.topk(probs, K, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    C = T if no_drop else max(1, int(T * K * capacity_factor / E))
    flat_e = gate_i.reshape(-1)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    first_pos = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device))
    rank_sorted = torch.arange(T * K, device=xt.device) - first_pos[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, sort_idx, rank_sorted)
    return Routing(probs, gate_w, gate_i, rank, rank < C, C)


def moe_ffn(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float, act: str, gated: bool, shared_expert: bool,
            no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output, aux loss).  ``no_drop=True`` sets the
    capacity to T so no assignment is dropped (decode).  A DTensor ``x``
    runs on each rank's shards (``_sharded_moe_ffn``)."""
    if isinstance(x, AnyDTensor):
        return _sharded_moe_ffn(params, x, num_experts=num_experts, top_k=top_k,
                                capacity_factor=capacity_factor, act=act, gated=gated,
                                shared_expert=shared_expert, no_drop=no_drop)
    B, S, d = x.shape
    T, E, K = B * S, num_experts, top_k
    combined, r, counts, xt = _dispatch(params, x, E, K, capacity_factor, act, gated,
                                        no_drop)
    # load-balance aux loss (Switch): E * sum_e frac_tokens_e * frac_prob_e
    aux = E * torch.sum(r.probs.mean(0) * (counts / (T * K)))
    if shared_expert:
        combined = combined + mlp(params["shared"], xt, act=act, gated=gated)
    return combined.reshape(B, S, d), aux


def _dispatch(params: dict, x: torch.Tensor, E: int, K: int, capacity_factor: float,
              act: str, gated: bool, no_drop: bool, experts=None):
    """The routed experts of ``moe_ffn`` -> (their combined output (T, d),
    the Routing, per-expert assignment counts (E,) f32, the tokens (T, d)).
    ``experts`` = (e0, n): ``params`` holds experts e0 .. e0+n-1 of the E
    (a rank's shard), and only the assignments to them are computed."""
    B, S, d = x.shape
    T = B * S
    xt = constrain_moe("tokens", x.reshape(T, d))
    r = route(params["router"], xt, E, K, capacity_factor, no_drop)
    # whole numbers in f32, so exact in any order; a shape that does not
    # depend on the data, unlike ``bincount``
    flat = r.gate_i.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))

    C = r.capacity
    flat_e, keep = flat, r.keep
    if experts is not None:
        e0, E = experts
        keep = keep & (flat_e >= e0) & (flat_e < e0 + E)
        flat_e = (flat_e - e0).clamp(0, E - 1)
    slot = flat_e * C + r.rank.clamp_max(C - 1)
    token_of = torch.arange(T, device=x.device).repeat_interleave(K)
    # each kept assignment owns its slot; drops all land on the trash row E*C
    buf = x.new_zeros((E * C + 1, d))
    buf[torch.where(keep, slot, E * C)] = xt[token_of]
    ebuf = constrain_moe("buf", buf[:E * C].view(E, C, d))
    out_buf = constrain_moe("buf", _expert_ffn(params, ebuf, act, gated)).reshape(E * C, d)

    gathered = constrain_moe("expanded", out_buf[slot] * keep[:, None].to(x.dtype))
    contrib = (gathered * r.gate_w.reshape(-1)[:, None].to(x.dtype)).view(T, K, d)
    combined = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):                  # token t's rows t*K .. t*K+K-1, in order
        combined = combined + contrib[:, k]
    return constrain_moe("tokens", combined), r, counts, xt


def _sharded_moe_ffn(params: dict, x, *, num_experts: int, top_k: int,
                     capacity_factor: float, act: str, gated: bool, shared_expert: bool,
                     no_drop: bool):
    """``moe_ffn`` of DTensors, expert-parallel over "model": tokens sharded
    over the data axes (replicated over "model"), the router replicated,
    each rank running the assignments to its own experts (and its slice of
    the shared expert's hidden dim), so the output is a partial sum over
    "model".  Parts a rank does not shard (and the aux loss's statistics)
    come from the rank at model coordinate 0 only; the aux loss is the
    whole batch's, from the ranks' partial router-probability sums and
    assignment counts.  The capacity is each rank's tokens': a per-group
    step's (efbv, local) as on one device; over data shards, per shard, as
    the reference's shard_map dispatch routes."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    m = layout.model_size(mesh)
    B, S, d = x.shape
    E, K = num_experts, top_k
    e_sh = layout.divides(E, layout.MODEL, mesh)

    def pl(dim, ok):
        return layout.local_placements(mesh, model_dim=dim if ok else None)

    leaves = [("router", params["router"], pl(0, False))]
    for k in ("w_in", "w_gate", "w_out"):
        if k in params:
            leaves.append((k, params[k], pl(0, e_sh)))
    s_sh = False
    if shared_expert:
        s_sh = layout.divides(params["shared"]["w_in"].shape[-1], layout.MODEL, mesh)
        for k, t in params["shared"].items():
            leaves.append(("shared/" + k, t, pl(0 if k == "w_out" else 1, s_sh)))
    part = e_sh or s_sh
    xpl = layout.local_placements(mesh, B)
    ypl = layout.local_placements(mesh, B, partial_model=part)
    # the statistics: summed over the batch shards and, where the output is
    # partial, over the experts' axis (zero but on the lead rank)
    spl = layout.local_placements(mesh, B, partial_batch=True, partial_model=part)
    mc = layout.model_coordinate(mesh)
    E_l = E // m if e_sh else E
    lead = mc == 0 or not part

    def local(xl, *ts):
        p = {}
        for (k, _, _), t in zip(leaves, ts):
            if k.startswith("shared/"):
                p.setdefault("shared", {})[k[7:]] = t
            else:
                p[k] = t
        # a part this rank does not own is scaled by 0, not dropped: every
        # rank's autograd graph (and so its backward's collectives) stays alike
        y, r, counts, xt = _dispatch(p, xl, E, K, capacity_factor, act, gated, no_drop,
                                     experts=(mc * E_l if e_sh else 0, E_l))
        y = y * float(e_sh or lead)
        if shared_expert:
            y = y + mlp(p["shared"], xt, act=act, gated=gated) * float(s_sh or lead)
        return (y.reshape(xl.shape), r.probs.sum(0) / (B * S) * float(lead),
                counts * float(lead))

    # x and the router feed every rank's share of the output, so their
    # gradients are partial sums over the experts' axis (``ypl``); the
    # weights' are partial sums over the batch shards
    wgrad = [layout.local_placements(
        mesh, B, partial_batch=True, model_dim=next((p.dim for p in q if p.is_shard()), None),
        partial_model=k == "router" and part) for k, _, q in leaves]
    y, psum, counts = local_map(
        local, out_placements=(ypl, spl, spl),
        in_placements=(xpl,) + tuple(q for _, _, q in leaves),
        in_grad_placements=(ypl,) + tuple(wgrad),
        device_mesh=mesh, redistribute_inputs=True)(x, *(t for _, t, _ in leaves))
    rep = [Replicate()] * mesh.ndim
    aux = E * torch.sum(psum.redistribute(mesh, rep)
                        * (counts.redistribute(mesh, rep) / (B * S * K)))
    return y, aux
