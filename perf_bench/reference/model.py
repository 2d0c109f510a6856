"""Plain float32 forward passes: the shared building blocks (products,
RMSNorm, rotary embeddings, causal attention, the SSD) and the entry points
``hidden``, ``logits`` and ``loss``, which hand the layers to the
configuration's family (``perf_bench/families/<family>.py``).

``params`` maps a leaf path (``"blocks/pos0/attn/wq"``) to an f32 tensor
or, for a block leaf, to the list of its layers' tensors.  Written from
the published descriptions, not from the program.

``fp8=True`` computes in float8 e4m3 under per-tensor scales, the precision
below the bf16 the configurations state: every weight product's operands
and result and the residual stream between layers (what the program holds
in bf16) are rounded to it.  It is the control that a sound comparison must reject.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
Q_CHUNK = 1024          # query rows per attention block (bounds the score tile)


def exact_f32() -> None:
    """Float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _FakeFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        s = FP8_MAX / t.abs().amax().clamp_min(1e-30)
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _FakeFP8.apply(_FakeFP8.apply(a) @ _FakeFP8.apply(b))
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, n, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int) -> torch.Tensor:
    """Causal softmax attention, q (B, S, H, hd), k / v (B, S, KV, hd) ->
    (B, S, H * hd); query blocks of ``Q_CHUNK`` rows against the keys they
    can see."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.view(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)      # (B, KV, G, S, hd)
    kk, vv = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)         # (B, KV, S, hd)
    outs = []
    for a in range(0, S, Q_CHUNK):
        b = min(S, a + Q_CHUNK)
        lo = max(0, a - window + 1) if window else 0
        s = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, a:b], kk[:, :, lo:b]) / math.sqrt(hd)
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(lo, b, device=q.device)[None, :]
        ok = ki <= qi
        if window:
            ok = ok & (qi - ki < window)
        s = s.masked_fill(~ok, float("-inf"))
        outs.append(torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, -1), vv[:, :, lo:b]))
    o = torch.cat(outs, dim=3)                                     # (B, KV, G, S, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): out[i, j] = x[j+1] + ... + x[i] for j <= i,
    -inf above the diagonal."""
    T = x.shape[-1]
    xe = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), diagonal=-1)
    xe = xe.masked_fill(~low, 0.0)
    out = torch.cumsum(xe, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(X, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """The paper's chunked SSD.  X (b, l, h, p) (x * dt), A (b, l, h) (A * dt),
    Bm / Cm (b, l, h, n); l a multiple of ``chunk``.  -> Y (b, l, h, p)."""
    b, l, h, p = X.shape
    c = l // chunk
    X = X.reshape(b, c, chunk, h, p)
    Bm = Bm.reshape(b, c, chunk, h, -1)
    Cm = Cm.reshape(b, c, chunk, h, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)              # (b, h, c, l)
    A_cum = torch.cumsum(A, dim=-1)
    Lmat = torch.exp(segsum(A))                                     # (b, h, c, l, s)
    CB = torch.einsum("bclhn,bcshn->bhcls", Cm, Bm)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * Lmat, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)               # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states = new_states[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, l, h, p)


def layer_stack(params: dict, cfg: dict, tokens: torch.Tensor, layer, fp8: bool,
                remat: bool) -> torch.Tensor:
    """tokens (B, S) -> the final-normed hidden states (B, S, D) of a model
    whose layers are all alike: the embedding, then ``layer(x, leaves,
    cfg, fp8)`` at each index of the ``blocks/pos0`` stack (``leaves`` keyed
    by the path below it), then the final norm.  ``remat`` recomputes each
    layer in the backward (it changes memory, not values)."""
    x = params["embed/tok"][tokens]
    if fp8:
        x = _FakeFP8.apply(x)
    names = [k[len("blocks/pos0/"):] for k in params if k.startswith("blocks/")]

    def one(x, *leaves):
        y = layer(x, dict(zip(names, leaves)), cfg, fp8)
        return _FakeFP8.apply(y) if fp8 else y

    for i in range(cfg["num_layers"]):
        leaves = [params["blocks/pos0/" + k][i] for k in names]
        x = (checkpoint(one, x, *leaves, use_reentrant=False) if remat
             else one(x, *leaves))
    return rmsnorm(x, params["final_norm/scale"], cfg["norm_eps"])


def _family(cfg: dict):
    from perf_bench.harness import bench
    return bench.load_py("families", cfg["family"])


def hidden(params: dict, cfg: dict, tokens: torch.Tensor, fp8: bool = False,
           remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> the final-normed hidden states (B, S, D), by the
    configuration's family.  Block leaves are given per layer
    (``params[path][i]``)."""
    return _family(cfg).hidden(params, cfg, tokens, fp8, remat)


def logits(params: dict, cfg: dict, h: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Hidden states -> logits over the real vocabulary (padded rows
    dropped); the family's own ``logits`` where it has one (a published
    model that scales its output)."""
    fam = _family(cfg)
    if hasattr(fam, "logits"):
        return fam.logits(params, cfg, h, fp8)
    w = params["embed/tok"].T if cfg.get("tie_embeddings") else params["embed/unembed"]
    return mm(h, w[:, : cfg["vocab_size"]], fp8)


def loss(params: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor,
         fp8: bool = False, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    lg = logits(params, cfg, hidden(params, cfg, tokens, fp8, remat), fp8)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1))
