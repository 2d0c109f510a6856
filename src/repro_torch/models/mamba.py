"""Mamba2 SSD (state-space duality) block (port of ``repro/models/mamba.py``).
[arXiv:2405.21060]

Training and prefill use the chunked form: a quadratic, attention-like term
inside chunks of length Q plus a recurrence over the chunks' states.  The
JAX package runs that recurrence as ``jax.lax.associative_scan``; the port
runs it as a loop over chunks (the state entering chunk k is the state
carried out of chunk k-1), so the additions happen in another order and the
SSD output agrees to rounding, not bit for bit.  Decode is the O(1)
recurrent step on a (B, H, hd, N) f32 state.

Parameterization as the reference: in_proj -> [z, x, B, C, dt], a causal
depthwise conv over (x, B, C), A a negative scalar per head (-exp(a_log)),
a per-head dt bias, the D skip, a gated RMSNorm before out_proj.  ``a_log``,
``dt_bias`` and ``D`` are f32 leaves in any model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_dense_init, along, features_whole, init_rmsnorm,
                                       project_out, rmsnorm)
from repro_torch.sharding import layout
from repro_torch.sharding.context import constrain_named
from repro_torch.sharding.layout import AnyDTensor, shard_start


def mamba_dims(d_model: int, cfg) -> dict:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.n_groups * cfg.d_state
    in_dim = 2 * d_inner + 2 * cfg.n_groups * cfg.d_state + n_heads
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim, in_dim=in_dim)


def init_mamba(gen, d_model: int, cfg, dtype, device, lead=()) -> dict:
    dims = mamba_dims(d_model, cfg)
    H, lead = dims["n_heads"], tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": _dense_init(gen, (d_model, dims["in_dim"]), dtype, device, lead=lead),
        "conv_w": _dense_init(gen, (cfg.d_conv, dims["conv_dim"]), dtype, device,
                              scale=0.5, lead=lead),
        "conv_b": torch.zeros(lead + (dims["conv_dim"],), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": torch.full(lead + (H,), -2.0, **f32),     # softplus^-1(~0.12)
        "D": torch.ones(lead + (H,), **f32),
        "norm": init_rmsnorm(dims["d_inner"], dtype, device, lead),
        "out_proj": _dense_init(gen, (dims["d_inner"], d_model), dtype, device, lead=lead),
    }


def _split_proj(params, u, cfg, dims):
    """u (B, S, d_model) -> z, the conv inputs (x, B, C), dt."""
    zxbcdt = features_whole(u) @ params["in_proj"]
    z, xBC, dt = torch.split(zxbcdt, [dims["d_inner"], dims["conv_dim"], dims["n_heads"]],
                             dim=-1)
    return z, xBC, dt


def _causal_conv(params, xBC, cfg):
    """Depthwise causal conv1d along S; xBC (B, S, conv_dim).  The sum of K
    shifted products, added in the reference's order."""
    K, S = cfg.d_conv, xBC.shape[1]
    pad = along(lambda t: F.pad(t, (0, 0, K - 1, 0)), xBC, 1)
    out = sum(pad[:, i: i + S, :] * params["conv_w"][i] for i in range(K))
    return F.silu(out + params["conv_b"])


def _ssd_chunked(x, dt, A, B_, C_, D, chunk: int, heads=None):
    """SSD chunked scan.  x (B,S,H,hd); dt (B,S,H) (after the softplus); A
    (H,) negative; B_, C_ (B,S,G,N); D (H,); S a multiple of ``chunk``.
    Returns y (B,S,H,hd) f32 and the final state (B,H,hd,N) f32.
    ``heads``: the global indices of the H heads given (a rank's shard of
    the heads), which pick each head's group; else all heads.  DTensor
    inputs run on each rank's shards (``_sharded_ssd``)."""
    if isinstance(x, AnyDTensor):
        return _sharded_ssd(x, dt, A, B_, C_, D, chunk)
    Bsz, S, H, hd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nch, rep = S // chunk, H // G

    xc = x.reshape(Bsz, nch, chunk, H, hd).float()
    dtc = dt.reshape(Bsz, nch, chunk, H).float()
    Bc = B_.reshape(Bsz, nch, chunk, G, N).float()
    Cc = C_.reshape(Bsz, nch, chunk, G, N).float()

    dA = dtc * A[None, None, None, :]                   # (B,K,Q,H), negative
    cs = torch.cumsum(dA, dim=2)                        # cumulative log-decay
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B,K,Q,Q,H) decay i<-j
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    # exp of the masked log-decay: the reference's where(causal, exp(seg), 0)
    # value for value, without exp overflowing above the diagonal
    L = torch.exp(torch.where(causal, seg, torch.full_like(seg, float("-inf"))))

    # intra-chunk (diagonal) term: per group, then broadcast to the heads
    CB = torch.einsum("bkqgn,bkpgn->bkqpg", Cc, Bc)     # (B,K,Q,Q,G)
    CB = _group_to_heads(CB, -1, rep, heads)            # (B,K,Q,Q,H)
    M = CB * L * dtc[:, :, None, :, :]                  # weight of source pos p
    y_diag = torch.einsum("bkqph,bkphd->bkqhd", M, xc)

    # chunk states: sum_p decay(end<-p) * dt_p * x_p outer B_p
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)        # (B,K,Q,H)
    w = decay_end * dtc
    Brep = _group_to_heads(Bc, 3, rep, heads)           # (B,K,Q,H,N)
    states = torch.einsum("bkqh,bkqhd,bkqhn->bkhdn", w, xc, Brep)

    # inter-chunk recurrence S_k = exp(sum dA_k) * S_{k-1} + states_k, in chunk
    # order; the state entering chunk k is S_{k-1} (zero for the first)
    chunk_decay = torch.exp(cs[:, :, -1, :])            # (B,K,H)
    carried = torch.zeros_like(states[:, 0])
    entering = []
    for k in range(nch):
        entering.append(carried)
        carried = states[:, k] + chunk_decay[:, k, :, None, None] * carried
    st_prev = torch.stack(entering, dim=1)              # (B,K,H,hd,N)

    # off-diagonal term: y_q += C_q . (decay(q<-start) * S_prev)
    decay_in = torch.exp(cs)                            # (B,K,Q,H)
    Crep = _group_to_heads(Cc, 3, rep, heads)           # (B,K,Q,H,N)
    y_off = torch.einsum("bkqhn,bkhdn,bkqh->bkqhd", Crep, st_prev, decay_in)

    y = (y_diag + y_off).reshape(Bsz, S, H, hd)
    y = y + x.float() * D[None, None, :, None]
    return y, carried


def _group_to_heads(t, dim: int, rep: int, heads):
    """Each group's slice repeated for its ``rep`` heads along ``dim``, or,
    with ``heads`` (global head indices), each given head's group."""
    if heads is None:
        return t.repeat_interleave(rep, dim=dim)
    return t.index_select(dim, heads)


def _sharded_ssd(x, dt, A, B_, C_, D, chunk: int):
    """``_ssd_chunked`` of DTensors: batch over the mesh's data axes and
    heads over the tensor-parallel axis wherever the dims divide
    (``sharding.layout``), the scan of each rank's shards computed locally
    (the groups replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    Bsz, _, H, _ = x.shape
    G = B_.shape[2]
    xpl = layout.local_placements(
        mesh, Bsz, model_dim=2 if layout.divides(H, layout.MODEL, mesh) else None)
    hpl = [Shard(0) if p.is_shard(2) else Replicate() for p in xpl]          # (H,)
    gpl = [Shard(0) if p.is_shard(0) else Replicate() for p in xpl]          # (B,S,G,N)
    spl = [Shard(1) if p.is_shard(2) else p for p in xpl]                    # (B,H,hd,N)
    # a rank's heads use every group: B's and C's gradients are partial sums
    # over the heads' mesh axis; A's and D's, over the batch shards
    ggrad = [Partial() if p.is_shard(2) else g for p, g in zip(xpl, gpl)]
    hgrad = [Partial() if p.is_shard(0) else h for p, h in zip(xpl, hpl)]
    start = shard_start(mesh, xpl, 2, H)

    def local(xl, dtl, al, bl, cl, dl):
        heads = torch.arange(start, start + xl.shape[2], device=xl.device) // (H // G)
        return _ssd_chunked(xl, dtl, al, bl, cl, dl, chunk, heads=heads)

    return local_map(local, out_placements=(xpl, spl),
                     in_placements=(xpl, xpl, hpl, gpl, gpl, hpl),
                     in_grad_placements=(xpl, xpl, hgrad, ggrad, ggrad, hgrad),
                     device_mesh=mesh,
                     redistribute_inputs=True)(x, dt, A, B_, C_, D)


def mamba_train(params, u, cfg, d_model: int) -> torch.Tensor:
    y, _ = mamba_forward(params, u, cfg, d_model)
    return y


def mamba_forward(params, u, cfg, d_model: int, return_cache: bool = False):
    """u (B, S, d_model) -> (out, final SSM state), or (out, the decode
    cache {"ssm", "conv"}) with ``return_cache``."""
    dims = mamba_dims(d_model, cfg)
    di, H, G, N = dims["d_inner"], dims["n_heads"], cfg.n_groups, cfg.d_state
    Bsz, S, _ = u.shape

    z, xBC_raw, dt = _split_proj(params, u, cfg, dims)
    xBC = _causal_conv(params, xBC_raw, cfg)
    x, B_, C_ = torch.split(xBC, [di, G * N, G * N], dim=-1)
    # optional SSD head sharding: keeps the intra-chunk tensors model-sharded
    # over heads where a launcher installed the "ssd_x" and "ssd_dt" specs
    x = constrain_named("ssd_x", x.reshape(Bsz, S, H, cfg.head_dim))
    B_ = B_.reshape(Bsz, S, G, N)
    C_ = C_.reshape(Bsz, S, G, N)
    dt = constrain_named("ssd_dt", F.softplus(dt.float() + params["dt_bias"]))
    A = -torch.exp(params["a_log"])

    chunk = min(cfg.chunk_size, S)
    if S % chunk:   # pad to whole chunks after the softplus: dt 0 = no contribution
        padlen = chunk - S % chunk
        x = along(lambda t: F.pad(t, (0, 0, 0, 0, 0, padlen)), x, 1)
        dt = along(lambda t: F.pad(t, (0, 0, 0, padlen)), dt, 1)
        B_ = along(lambda t: F.pad(t, (0, 0, 0, 0, 0, padlen)), B_, 1)
        C_ = along(lambda t: F.pad(t, (0, 0, 0, 0, 0, padlen)), C_, 1)
    y, state = _ssd_chunked(x, dt, A, B_, C_, params["D"], chunk)
    y = y[:, :S].reshape(Bsz, S, di).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = project_out(y, params["out_proj"])
    if return_cache:
        # decode's cache: the final SSM state and the last d_conv-1 raw
        # (pre-conv) inputs, left-padded when the prompt is shorter; a copy,
        # since a view would hold the whole (B, S, in_dim) projection alive
        # for every layer until the prefill ends
        K = cfg.d_conv
        tail = xBC_raw[:, -(K - 1):, :].clone() if S >= K - 1 else \
            along(lambda t: F.pad(t, (0, 0, K - 1 - S, 0)), xBC_raw, 1)
        return out, {"ssm": state, "conv": tail}
    return out, state


def mamba_cache_spec(d_model: int, cfg, batch: int, dtype) -> dict:
    """Decode-cache leaves as ``meta`` tensors (shape and dtype, no storage)."""
    dims = mamba_dims(d_model, cfg)
    meta = dict(device="meta")
    return {"ssm": torch.empty((batch, dims["n_heads"], cfg.head_dim, cfg.d_state),
                               dtype=torch.float32, **meta),
            "conv": torch.empty((batch, cfg.d_conv - 1, dims["conv_dim"]), dtype=dtype,
                                **meta)}


def _recurrent_step(x, B_, C_, dt_t, A, D, ssm, heads=None):
    """The decode recurrence: x (B,H,hd), B_/C_ (B,G,N), dt_t (B,H) f32, A /
    D (H,), ssm (B,H,hd,N) -> (y (B,H,hd), the new state).  ``heads``:
    the global indices of the H heads given (a rank's shard), else all.
    A DTensor state runs on each rank's shards (``local_map``): batch and
    heads as the state's placements, the groups replicated."""
    if isinstance(ssm, AnyDTensor):
        return _sharded_recurrent_step(x, B_, C_, dt_t, A, D, ssm)
    da = torch.exp(dt_t * A[None])                       # (B,H)
    H, G = x.shape[1], B_.shape[1]
    if heads is None:
        rep = H // G
        Brep = B_.repeat_interleave(rep, dim=1)          # (B,H,N)
        Crep = C_.repeat_interleave(rep, dim=1)
    else:
        Brep, Crep = (t.index_select(1, heads) for t in (B_, C_))
    state = ssm * da[..., None, None] + torch.einsum(
        "bh,bhd,bhn->bhdn", dt_t, x, Brep)
    y = torch.einsum("bhdn,bhn->bhd", state, Crep) + x * D[None, :, None]
    return y, state


def _sharded_recurrent_step(x, B_, C_, dt_t, A, D, ssm):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ssm.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in ssm.placements]   # (B,H,hd,N)
    hpl = [Shard(0) if p.is_shard(1) else Replicate() for p in pl]       # (H,)
    gpl = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]       # (B,G,N)
    H, G = ssm.shape[1], B_.shape[1]
    start = shard_start(mesh, pl, 1, H)

    def local(xl, bl, cl, dtl, al, dl, sl):
        heads = torch.arange(start, start + xl.shape[1], device=xl.device) // (H // G)
        return _recurrent_step(xl, bl, cl, dtl, al, dl, sl, heads=heads)

    return local_map(local, out_placements=(pl, pl),
                     in_placements=(pl, gpl, gpl, pl, hpl, hpl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(x, B_, C_, dt_t, A, D, ssm)


def mamba_decode(params, u, cache: dict, cfg, d_model: int):
    """One-token step.  u (B, 1, d_model); cache {ssm (B,H,hd,N), conv
    (B,K-1,conv_dim)}.  Returns (out, the new cache's tensors)."""
    dims = mamba_dims(d_model, cfg)
    di, H, G, N = dims["d_inner"], dims["n_heads"], cfg.n_groups, cfg.d_state
    hd = cfg.head_dim
    Bsz = u.shape[0]

    z, xBC, dt = _split_proj(params, u, cfg, dims)       # (B,1,*)
    conv_in = torch.cat([cache["conv"], xBC], dim=1)     # (B,K,conv_dim)
    conv_out = torch.sum(conv_in * params["conv_w"][None], dim=1, keepdim=True) \
        + params["conv_b"]
    xBC_t = F.silu(conv_out)                             # (B,1,conv_dim)
    new_conv = conv_in[:, 1:]

    x, B_, C_ = torch.split(xBC_t[:, 0], [di, G * N, G * N], dim=-1)
    x = x.reshape(Bsz, H, hd).float()
    B_ = B_.reshape(Bsz, G, N).float()
    C_ = C_.reshape(Bsz, G, N).float()
    dt_t = F.softplus(dt[:, 0].float() + params["dt_bias"])   # (B,H)
    A = -torch.exp(params["a_log"])
    y, state = _recurrent_step(x, B_, C_, dt_t, A, params["D"], cache["ssm"])

    y = y.reshape(Bsz, 1, di).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = y @ params["out_proj"]
    return out, {"ssm": state, "conv": new_conv}
