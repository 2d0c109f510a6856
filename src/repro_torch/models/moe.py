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

The expert-parallel paths of the reference (``moe_ffn_alltoall``,
``moe_ffn_shardmap``) need a device mesh; here they raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, init_mlp, mlp

MESH_TODO = ("expert-parallel MoE over a device mesh is not ported "
             "(ROADMAP.md Queue 1, item 8: multi-GPU)")


def moe_apply(params: dict, x: torch.Tensor, specs: Optional[dict] = None,
              **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: ``specs`` is what the reference's launcher installs for a
    mesh (``{"impl": "alltoall" | "shardmap", "mesh": ..., ...}``); without
    one, the single-device scatter path."""
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
    capacity to T so no assignment is dropped (decode)."""
    B, S, d = x.shape
    T, E, K = B * S, num_experts, top_k
    xt = x.reshape(T, d)
    r = route(params["router"], xt, E, K, capacity_factor, no_drop)

    # load-balance aux loss (Switch): E * sum_e frac_tokens_e * frac_prob_e
    counts = torch.bincount(r.gate_i.reshape(-1), minlength=E).float()
    aux = E * torch.sum(r.probs.mean(0) * (counts / (T * K)))

    C = r.capacity
    flat_e = r.gate_i.reshape(-1)
    slot = flat_e * C + r.rank.clamp_max(C - 1)
    token_of = torch.arange(T, device=x.device).repeat_interleave(K)
    # each kept assignment owns its slot; drops all land on the trash row E*C
    buf = x.new_zeros((E * C + 1, d))
    buf[torch.where(r.keep, slot, E * C)] = xt[token_of]
    out_buf = _expert_ffn(params, buf[:E * C].view(E, C, d), act, gated).reshape(E * C, d)

    gathered = out_buf[slot] * r.keep[:, None].to(x.dtype)          # (T*K, d)
    contrib = (gathered * r.gate_w.reshape(-1)[:, None].to(x.dtype)).view(T, K, d)
    combined = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):                  # token t's rows t*K .. t*K+K-1, in order
        combined = combined + contrib[:, k]

    if shared_expert:
        combined = combined + mlp(params["shared"], xt, act=act, gated=gated)
    return combined.reshape(B, S, d), aux
