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

A layer that holds a share of the experts (``held`` = (first id, count),
one expert-parallel rank's) routes over all of them and adds the part of
the result its own experts give.  ``dropless`` routing (granite-4.0-h's,
in training and prefill too) drops nothing: the held assignments are sorted
by expert and run as grouped products over each expert's rows
(``torch._grouped_mm``) in a buffer sized for the most a call can have;
the counts stay on the device, so no call waits for the host.  The whole
layer's forward and backward are the ``model/moe/forward`` and
``model/moe/backward`` spans (the backward timed on autograd's thread), and
the tally ``moe/held_rows`` (``obs.trace.tally``) counts the assignments
held experts computed, beside ``moe/tokens``, in every call (a remat
recompute's too).

The dispatcher reads the MoE specs a launcher installed
(``sharding.context.set_moe_specs``), as the reference's does; without any,
the scatter path runs, its tensors passing through ``constrain_moe`` at the
reference's points.  The expert-parallel paths over a device mesh
(``moe_ffn_shardmap``, ``moe_ffn_alltoall``; ``repro/models/moe.py:136-352``)
run on DTensors: each rank's part runs in ``local_map`` on its local
tensors, and the reference's ``lax.all_gather`` / ``all_to_all`` / ``psum``
/ ``pmean`` over the mesh axes are functional collectives
(``torch.distributed._functional_collectives``) over the axes' process
groups, which also trace under ``FakeTensorMode`` on a ``fake`` group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, init_mlp, mlp
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import layout
from repro_torch.sharding.context import constrain_moe, get_moe_specs
from repro_torch.sharding.layout import AnyDTensor


def moe_apply(params: dict, x: torch.Tensor, specs: Optional[dict] = None,
              **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher: ``specs`` (default: what a launcher installed with
    ``sharding.context.set_moe_specs``, ``{"impl": "alltoall" | "shardmap",
    "gather_quant": ...}``) picks an expert-parallel path, which runs on
    the mesh of the DTensor ``x`` (the reference passes the launcher's mesh
    and data axes; a per-rank step's sub-mesh is the one to use); without
    specs, the single-device scatter path."""
    if specs is None:
        specs = get_moe_specs()
    if specs and specs.get("impl") == "alltoall":
        return moe_ffn_alltoall(params, x, **kw)
    if specs and specs.get("impl") == "shardmap":
        return moe_ffn_shardmap(params, x, gather_quant=specs.get("gather_quant", False), **kw)
    return moe_ffn(params, x, **kw)


def init_moe(gen, d_model: int, d_ff: int, num_experts: int, gated: bool,
             shared_expert: bool, dtype, device, lead=(), shared_d_ff: int = 0,
             held: int = 0) -> dict:
    """The router over all ``num_experts``, the ``held`` experts (all when
    0) and the shared expert, of width ``shared_d_ff`` (``d_ff`` when 0)."""
    E, n = num_experts, held or num_experts
    p = {"router": _dense_init(gen, (d_model, E), torch.float32, device, scale=0.02,
                               lead=lead),
         "w_in": _dense_init(gen, (n, d_model, d_ff), dtype, device, lead=lead),
         "w_out": _dense_init(gen, (n, d_ff, d_model), dtype, device, lead=lead)}
    if gated:
        p["w_gate"] = _dense_init(gen, (n, d_model, d_ff), dtype, device, lead=lead)
    if shared_expert:
        p["shared"] = init_mlp(gen, d_model, shared_d_ff or d_ff, gated, dtype, device, lead)
    return p


def _ffn_act(h: torch.Tensor, g, act: str, gated: bool) -> torch.Tensor:
    """As the reference: gated experts take silu for "silu", else gelu (tanh)
    of the gate times ``h``; ungated ones squared ReLU for "relu2", else silu."""
    if gated:
        return (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * h
    return torch.square(F.relu(h)) if act == "relu2" else F.silu(h)


def _expert_ffn(p: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d), batched over the experts."""
    h = torch.bmm(x, p["w_in"])
    h = _ffn_act(h, torch.bmm(x, p["w_gate"]) if gated else None, act, gated)
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
    return route_logits(xt.float() @ router, num_experts, top_k, capacity_factor, no_drop)


def _gates(logits: torch.Tensor, top_k: int):
    """f32 router logits (T, E) -> (softmax (T, E), the top-k gates
    renormalized over the k (T, K), their experts (T, K))."""
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, top_k, dim=-1)
    return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), gate_i


def route_logits(logits: torch.Tensor, num_experts: int, top_k: int,
                 capacity_factor: float, no_drop: bool = False) -> Routing:
    """``route`` from the f32 router logits (T, E)."""
    T, E, K = logits.shape[0], num_experts, top_k
    device = logits.device
    probs, gate_w, gate_i = _gates(logits, K)
    C = T if no_drop else max(1, int(T * K * capacity_factor / E))
    flat_e = gate_i.reshape(-1)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    first_pos = torch.searchsorted(sorted_e, torch.arange(E, device=device))
    rank_sorted = torch.arange(T * K, device=device) - first_pos[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, sort_idx, rank_sorted)
    return Routing(probs, gate_w, gate_i, rank, rank < C, C)


def moe_ffn(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float, act: str, gated: bool, shared_expert: bool,
            no_drop: bool = False, held: Optional[Tuple[int, int]] = None,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output, aux loss).  ``no_drop=True`` sets the
    capacity to T so no assignment is dropped (decode); ``dropless`` routes
    with no capacity at all (``_dropless``).  ``held`` = (e0, n): ``params``
    holds experts e0 .. e0+n-1 of the ``num_experts`` the router scores, and
    the output is their part with the shared expert's, routed dropless.  A
    DTensor ``x`` runs on each rank's shards (``_sharded_moe_ffn``)."""
    if isinstance(x, AnyDTensor):
        if held is not None or dropless:
            raise NotImplementedError("a held share or dropless routing on a mesh")
        return _sharded_moe_ffn(params, x, num_experts=num_experts, top_k=top_k,
                                capacity_factor=capacity_factor, act=act, gated=gated,
                                shared_expert=shared_expert, no_drop=no_drop)
    B, S, d = x.shape
    T, E, K = B * S, num_experts, top_k
    marks = None
    if obs_trace.enabled() and torch.is_grad_enabled() and x.requires_grad:
        marks = _SpanHolder("model/moe/backward")
    with obs_trace.span("model/moe/forward"):
        if marks is not None:
            x = _Mark.apply(x, marks, False)        # its backward ends the layer's
        if dropless or held is not None:
            combined, probs, counts, xt, computed = _dropless(params, x, E, K, act, gated,
                                                              held)
        else:
            combined, r, counts, xt = _dispatch(params, x, E, K, capacity_factor, act,
                                                gated, no_drop)
            probs, computed = r.probs, None
        # load-balance aux loss (Switch): E * sum_e frac_tokens_e * frac_prob_e
        aux = E * torch.sum(probs.mean(0) * (counts / (T * K)))
        if shared_expert:
            combined = combined + mlp(params["shared"], xt, act=act, gated=gated)
        out = combined.reshape(B, S, d)
        if obs_trace.enabled():
            if computed is None:                    # capacity routing: the kept
                computed = r.keep.sum()
            obs_trace.tally("moe/held_rows", computed)
            obs_trace.tally("moe/tokens", T)
        if marks is not None:
            out = _Mark.apply(out, marks, True)     # its backward starts the layer's
    return out, aux


class _SpanHolder:
    """The span one layer call's backward keeps open between its marks."""
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name, self.span = name, None


class _Mark(torch.autograd.Function):
    """The identity; its backward opens (``opening``) or closes the holder's
    span.  On a layer's output and input, the span covers the layer's
    backward, on autograd's thread (a remat recompute's marks are never
    run backward).  The opening mark saves its input and reads it back
    before it opens the span: under remat that read recomputes the block,
    so the span holds the layer's backward alone."""

    @staticmethod
    def forward(ctx, x, holder: _SpanHolder, opening: bool):
        ctx.holder, ctx.opening = holder, opening
        if opening:
            ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        h = ctx.holder
        if ctx.opening:
            ctx.saved_tensors                       # the recompute, if any, runs here
            h.span = obs_trace.span(h.name)
            h.span.__enter__()
        elif h.span is not None:
            h.span.__exit__(None, None, None)
            h.span = None
        return g, None, None


def _grouped_ffn(p: dict, rows: torch.Tensor, ends: torch.Tensor, act: str,
                 gated: bool) -> torch.Tensor:
    """The held experts' FFN over ``rows`` (R, d) sorted by expert, expert
    e's rows ending at ``ends[e]`` (int32, on the device) -> (R, d).  No
    product computes a row past ``ends[-1]``: those rows of the result (and
    of its input's gradient) are undefined."""
    h = torch._grouped_mm(rows, p["w_in"], offs=ends)
    g = torch._grouped_mm(rows, p["w_gate"], offs=ends) if gated else None
    return torch._grouped_mm(_ffn_act(h, g, act, gated), p["w_out"], offs=ends)


def _dropless(params: dict, x: torch.Tensor, E: int, K: int, act: str, gated: bool,
              held: Optional[Tuple[int, int]] = None):
    """The held experts' part of ``moe_ffn`` with no assignment dropped ->
    (their combined output (T, d), the router softmax (T, E), assignments
    per expert (E,) f32, the tokens (T, d), the held assignments (0-d, on
    the device)).

    The (token, k) assignments are sorted by held expert (a stable sort:
    token order within an expert), those to other experts after them.  At
    most ``R = T * min(K, n)`` are held (a token's k experts are distinct),
    so the first R sorted rows hold every held assignment, whatever the
    routing: the products run over each expert's rows of that buffer
    (``_grouped_ffn``), and rows past the held ones are zeros whose
    gradient is dropped.  Each token then sums its k gated outputs in one
    reduction, with no atomics.  No gather repeats an index more than K
    times: the backward's accumulation of a gather serializes over
    repeats."""
    B, S, d = x.shape
    T = B * S
    e0, n = held if held is not None else (0, E)
    xt = x.reshape(T, d)
    probs, gate_w, gate_i = _gates(xt.float() @ params["router"], K)
    local = gate_i.reshape(-1) - e0
    mine = (local >= 0) & (local < n)
    key, order = torch.sort(torch.where(mine, local, n), stable=True)
    ends = torch.searchsorted(key, torch.arange(1, n + 1, device=x.device)).to(torch.int32)
    R = T * min(K, n)
    valid = (torch.arange(R, device=x.device) < ends[-1])[:, None]
    # rows past the held ones are zeros whose gradient is dropped (their
    # gathers' indices, like every other, repeat a token at most K times)
    y = _grouped_ffn(params, torch.where(valid, xt[order[:R] // K], 0.0), ends, act, gated)
    # each assignment's row of y: a held one's lies below ends[-1] <= R; the
    # others' are masked out (taken mod R, the gather repeats no row often)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=x.device))
    contrib = torch.where(mine[:, None], y[pos % R], 0.0) * gate_w.reshape(-1, 1).to(x.dtype)
    return contrib.view(T, K, d).sum(1), probs, _counts(gate_i, E), xt, ends[-1]


def _counts(gate_i: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments per expert (E,) f32: whole numbers, so exact in any
    order; a shape that does not depend on the data, unlike ``bincount``."""
    flat = gate_i.reshape(-1)
    return torch.zeros(E, dtype=torch.float32, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))


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
    counts = _counts(r.gate_i, E)

    C = r.capacity
    flat_e, keep = r.gate_i.reshape(-1), r.keep
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


# ---------------------------------------------------------------------------
# The expert-parallel paths over a mesh (``repro/models/moe.py:136-352``).
# ---------------------------------------------------------------------------
def _wait(t):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(t)


class _SumReplicated(torch.autograd.Function):
    """``psum`` of a value that every rank of the group then uses alike:
    each rank's cotangent is already the whole one, so the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumPartial(torch.autograd.Function):
    """``psum`` of a value each rank of the group then uses in its own way
    (its own d-slice): the cotangents are partial, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


class _MeanReplicated(torch.autograd.Function):
    """``pmean`` over a group of a value every rank then uses alike: the sum
    over the group divided by its size; the backward divides each rank's
    whole cotangent by the size."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed._functional_collectives as funcol
        ctx.n = n
        return _wait(funcol.all_reduce(x, "sum", group)) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _all_gather_last(x, group):
    """(T, d / n) -> (T, d): the group's d-slices side by side, in rank order
    (``lax.all_gather(..., axis=1, tiled=True)``); the backward sums each
    rank's cotangent of the whole and keeps this rank's slice."""
    import torch.distributed._functional_collectives as funcol
    # torch 2.13 renamed the autograd all-gather (the old name warns there)
    gather = getattr(funcol, "all_gather_single_autograd", funcol.all_gather_tensor_autograd)
    return _wait(gather(x.contiguous(), 1, group))


def _all_to_all(x, group):
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` of x (n, rows, w):
    block i goes to rank i, and block j of the result came from rank j."""
    import torch.distributed._functional_collectives as funcol
    n = x.shape[0]
    out = _wait(funcol.all_to_all_single_autograd(x.reshape(-1, x.shape[-1]).contiguous(),
                                                  None, None, group))
    return out.reshape(n, -1, x.shape[-1])


def _lead_grad(x, lead: bool):
    """``x`` with its gradient kept on the lead rank only: a value every
    rank of "model" computes alike (the aux loss) feeds back once."""
    return x.detach() + (x - x.detach()) * float(lead)


def _aux_loss(r: Routing, E: int, K: int) -> torch.Tensor:
    """The Switch load-balance loss of this rank's tokens."""
    T = r.probs.shape[0]
    return E * torch.sum(r.probs.mean(0) * (_counts(r.gate_i, E) / (T * K)))


def _expert_axis(mesh):
    """The mesh facts both paths need: (the "model" size, this rank's model
    coordinate, the model and data process groups, the data size)."""
    names = layout.mesh_axis_names(mesh)
    daxes = layout.data_axes(mesh)
    n_data = 1
    for a in daxes:
        n_data *= mesh.size(names.index(a))
    mgroup = mesh.get_group(layout.MODEL) if layout.MODEL in names else None
    dgroup = layout.process_group(mesh, daxes) if daxes else None
    return layout.model_size(mesh), layout.model_coordinate(mesh), mgroup, dgroup, n_data


def _mesh_of(x):
    if not isinstance(x, AnyDTensor):
        raise ValueError("the expert-parallel MoE paths take a DTensor input on the mesh")
    return x.device_mesh


def _weight_leaves(params, mesh, B: int, e_sh: bool):
    """(placements, gradient placements) of router, w_in, w_gate, w_out:
    the router replicated, its gradient partial over the batch shards and
    "model"; the experts sharded over "model" on their expert dim where E
    divides (else replicated, their gradients partial over "model"), their
    gradients partial over the batch shards."""
    rpl = layout.local_placements(mesh)
    rgrad = layout.local_placements(mesh, B, partial_batch=True, partial_model=True)
    wpl = layout.local_placements(mesh, model_dim=0 if e_sh else None)
    wgrad = layout.local_placements(mesh, B, partial_batch=True,
                                    model_dim=0 if e_sh else None, partial_model=not e_sh)
    w_gate = params.get("w_gate", params["w_in"])       # a placeholder when ungated
    return ((params["router"], params["w_in"], w_gate, params["w_out"]),
            (rpl, wpl, wpl, wpl), (rgrad, wgrad, wgrad, wgrad))


def moe_ffn_shardmap(params: dict, x, *, num_experts: int, top_k: int,
                     capacity_factor: float, act: str, gated: bool, shared_expert: bool,
                     gather_quant: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with the tokens replicated over "model"
    (``repro/models/moe.py:246-352``) of a DTensor ``x`` (B, S, d) on its
    mesh (data axes "pod" / "data" and "model"): each rank gathers its
    tokens' d-slices over "model" (an all-gather), or
    with ``gather_quant`` their per-token absmax int8 codes and f32 scales
    (``round``, in plain torch as the reference's jnp), routes them
    (capacity ``C = max(1, int(T_loc*K*cf/E))`` of its local token count),
    runs its own E / n_model experts, each through a (C + 1)-row buffer
    whose last row is the trash slot, and sums their weighted outputs per
    token in f32; the combine is a ``psum`` over "model" (in bf16 under
    ``gather_quant``) and the aux loss the ``pmean`` over the data axes of
    each rank's statistic.  The shared expert runs on the DTensors outside,
    as the reference's runs outside its ``shard_map``."""
    from torch.distributed.tensor.experimental import local_map

    mesh = _mesh_of(x)
    B, S, d = x.shape
    E, K = num_experts, top_k
    n_model, mc, mgroup, dgroup, n_data = _expert_axis(mesh)
    assert E % n_model == 0 or n_model % E == 0, (E, n_model)
    e_per = max(1, E // n_model)
    e_sh = E % n_model == 0
    d_sh = mgroup is not None and layout.divides(d, layout.MODEL, mesh)
    if gather_quant and not d_sh:
        raise ValueError(f"gather_quant needs d={d} split over 'model' ({n_model})")
    lead = mc == 0

    def gather(xt):
        """(T_loc, d / n_model) my d-shard -> (T_loc, d)."""
        if not gather_quant:
            return _all_gather_last(xt, mgroup)
        xf = xt.float()
        scale = xf.abs().amax(dim=1, keepdim=True) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        qg = _all_gather_last(q, mgroup)                      # int8 on the wire
        sg = _all_gather_last(scale, mgroup)                  # (T_loc, n_model)
        dsh = xt.shape[1]
        out = qg.reshape(qg.shape[0], n_model, dsh).float() * sg[:, :, None]
        return out.reshape(qg.shape[0], n_model * dsh).to(xt.dtype)

    def local(xl, router, w_in, w_gate, w_out):
        xt = xl.reshape(-1, xl.shape[-1])
        if d_sh:
            xt = gather(xt)
        T_loc = xt.shape[0]
        r = route(router, xt, E, K, capacity_factor)
        C = r.capacity
        aux = _lead_grad(_aux_loss(r, E, K), lead)
        if dgroup is not None:
            aux = _MeanReplicated.apply(aux, dgroup, n_data)
        flat_e = r.gate_i.reshape(-1)
        token_of = torch.arange(T_loc, device=xt.device).repeat_interleave(K)
        wk_all = r.gate_w.reshape(-1)
        rows = xt[token_of]
        combined = torch.zeros((T_loc, d), dtype=torch.float32, device=xt.device)
        for j in range(e_per):
            e_id = mc * e_per + j
            # a rank past the last expert (n_model > E) owns none: its part
            # is scaled by 0, not skipped, so every rank's graph stays alike
            own = float(e_id < E)
            w = j if e_sh else min(e_id, E - 1)
            mine = r.keep & (flat_e == e_id)
            buf = xt.new_zeros((C + 1, d))
            buf[torch.where(mine, r.rank, C)] = rows               # C: the trash slot
            h = buf[:C] @ w_in[w]
            h = _ffn_act(h, buf[:C] @ w_gate[w] if gated else None, act, gated)
            y = h @ w_out[w]                                       # (C, d)
            contrib = (y[r.rank.clamp_max(C - 1)] * (wk_all * mine)[:, None] * own
                       ).float().view(T_loc, K, d)
            for k in range(K):
                combined = combined + contrib[:, k]
        if mgroup is not None:
            combined = _SumReplicated.apply(
                combined.to(torch.bfloat16) if gather_quant else combined, mgroup)
        return combined.to(x.dtype).reshape(xl.shape[:-1] + (d,)), aux

    weights, wpl, wgrad = _weight_leaves(params, mesh, B, e_sh)
    xpl = layout.local_placements(mesh, B, model_dim=2 if d_sh else None)
    ypl = layout.local_placements(mesh, B)
    y, aux = local_map(
        local, out_placements=(ypl, layout.local_placements(mesh)),
        in_placements=(xpl,) + wpl, in_grad_placements=(xpl,) + wgrad,
        device_mesh=mesh, redistribute_inputs=True)(x, *weights)
    if shared_expert:
        y = y + mlp(params["shared"], x, act=act, gated=gated)
    return y, aux


def moe_ffn_alltoall(params: dict, x, *, num_experts: int, top_k: int,
                     capacity_factor: float, act: str, gated: bool, shared_expert: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with the tokens d-sharded all the way
    (``repro/models/moe.py:136-231``): each rank's partial router logits of
    its d-slice are summed over "model" (``psum``), so every rank routes
    alike; each rank buckets its d-slice of every routed row by expert into
    an (E, C, d / n_model) send buffer, one all-to-all brings each rank the
    whole rows of its own E / n_model experts, it runs them, a second
    all-to-all returns each source its d-slice of the outputs, and the
    combine adds them into an f32 (T_loc, d / n_model) one expert at a
    time.  The aux loss is the ``pmean`` over the data axes of each rank's
    statistic.  ``x`` as ``moe_ffn_shardmap``'s."""
    from torch.distributed.tensor.experimental import local_map

    mesh = _mesh_of(x)
    B, S, d = x.shape
    E, K = num_experts, top_k
    n_model, mc, mgroup, dgroup, n_data = _expert_axis(mesh)
    assert E % n_model == 0, (E, n_model)
    e_per = E // n_model
    if mgroup is None or not layout.divides(d, layout.MODEL, mesh):
        raise ValueError(f"moe_ffn_alltoall needs d={d} split over a 'model' axis")
    dsh = d // n_model
    lead = mc == 0

    def local(xl, router, w_in, w_gate, w_out):
        xt = xl.reshape(-1, dsh)
        T_loc = xt.shape[0]
        logits = xt.float() @ router[mc * dsh:(mc + 1) * dsh]
        logits = _SumPartial.apply(logits, mgroup)
        r = route_logits(logits, E, K, capacity_factor)
        C = r.capacity
        aux = _lead_grad(_aux_loss(r, E, K), lead)
        if dgroup is not None:
            aux = _MeanReplicated.apply(aux, dgroup, n_data)
        flat_e = r.gate_i.reshape(-1)
        token_of = torch.arange(T_loc, device=xt.device).repeat_interleave(K)
        rows = xt[token_of]
        bufs = []
        for e_id in range(E):                  # my d-slice of each expert's rows
            mine = r.keep & (flat_e == e_id)
            buf = xt.new_zeros((C + 1, dsh))
            buf[torch.where(mine, r.rank, C)] = rows               # C: the trash slot
            bufs.append(buf[:C])
        send = torch.stack(bufs).reshape(n_model, e_per * C, dsh)
        recv = _all_to_all(send, mgroup)
        # recv[j]: d-slice j of my experts' rows -> whole rows
        full = recv.transpose(0, 1).reshape(e_per, C, n_model * dsh)
        h = torch.bmm(full, w_in)
        h = _ffn_act(h, torch.bmm(full, w_gate) if gated else None, act, gated)
        y = torch.bmm(h, w_out)                                    # (e_per, C, d)
        yb = y.reshape(e_per * C, n_model, dsh).transpose(0, 1)
        back = _all_to_all(yb, mgroup).reshape(E, C, dsh)
        combined = torch.zeros((T_loc, dsh), dtype=torch.float32, device=xt.device)
        wk_all = r.gate_w.reshape(-1)
        slot = r.rank.clamp_max(C - 1)
        for e_id in range(E):                  # one expert at a time, as the reference
            mine = r.keep & (flat_e == e_id)
            contrib = (back[e_id][slot].float() * (wk_all * mine)[:, None]).view(T_loc, K, dsh)
            for k in range(K):
                combined = combined + contrib[:, k]
        return combined.to(x.dtype).reshape(xl.shape), aux

    weights, wpl, wgrad = _weight_leaves(params, mesh, B, True)
    xpl = layout.local_placements(mesh, B, model_dim=2)
    y, aux = local_map(
        local, out_placements=(xpl, layout.local_placements(mesh)),
        in_placements=(xpl,) + wpl, in_grad_placements=(xpl,) + wgrad,
        device_mesh=mesh, redistribute_inputs=True)(x, *weights)
    if shared_expert:
        y = y + mlp(params["shared"], x, act=act, gated=gated)
    return y, aux
