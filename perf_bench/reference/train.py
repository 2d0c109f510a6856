"""Plain float32 training references: the qsgd quantizer, EF-BV (Ch. 2 of
the paper) and AdamW, on the flat vector of all parameters.

The flat vector is every leaf, in the benchmark's sorted path order; the
parameters, their gradient, Adam's moments and the EF-BV control variates
are each one f32 buffer of it, and the model's leaves are views into the
parameter buffer whose gradients accumulate in place into the gradient
buffer.  After each update a parameter of a bf16 leaf is rounded to bf16:
the configurations store their weights in bf16, and a stored weight is
what the next step reads.

EF-BV with n groups, compressor C, and (lambda, nu) from the compressor's
variance omega (Prop. 2.2.2): ``d_i = C(g_i - h_i)``, ``h_i += lambda d_i``,
``g = h_bar + nu mean_i d_i``, ``h_bar += lambda mean_i d_i``.  C is qsgd
over rows of 512 elements: ``scale = max |x| / s`` (s = 2^(b-1) - 1, 1 where
the row is 0), ``q = clamp(floor(x / scale + u), -s, s)``, ``C(x) = q scale``
with u the uniform draws the harness hands over.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perf_bench.reference import model

QBLOCK = 512
CHUNK_ROWS = 1 << 16
CHUNK = 1 << 26         # elements per pass of the optimizer and of a norm


def levels(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def qsgd_omega(bits: int) -> float:
    """The variance bound of the row quantizer: block / (4 s^2)."""
    s = levels(bits)
    return QBLOCK / (4.0 * s * s)


def efbv_lambda_nu(bits: int, n_groups: int):
    """(lambda*, nu*) for an unbiased compressor (eta = 0) of variance omega,
    the groups' draws independent (omega_ran = omega / n)."""
    om = qsgd_omega(bits)
    return min(1.0 / (1.0 + om), 1.0), min(1.0 / (1.0 + om / n_groups), 1.0)


def qsgd_(x: torch.Tensor, noise, bits: int) -> torch.Tensor:
    """Quantize-dequantize the flat f32 ``x`` in place, rows of 512 (the
    last row zero-padded); ``noise.rows(r0, r1)`` gives rows r0..r1's
    uniform draws (r1 - r0, 512)."""
    s = float(levels(bits))
    d = x.numel()
    full = d // QBLOCK
    x2d = x[: full * QBLOCK].view(full, QBLOCK)

    def rows_(blk, u):
        scale = blk.abs().amax(dim=1, keepdim=True) / s
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        blk.copy_(torch.floor(blk / scale + u).clamp_(-s, s).mul_(scale))

    for r0 in range(0, full, CHUNK_ROWS):
        r1 = min(full, r0 + CHUNK_ROWS)
        rows_(x2d[r0:r1], noise.rows(r0, r1))
    if d > full * QBLOCK:
        tail = torch.zeros((1, QBLOCK), dtype=x.dtype, device=x.device)
        tail[0, : d - full * QBLOCK] = x[full * QBLOCK:]
        rows_(tail, noise.rows(full, full + 1))
        x[full * QBLOCK:] = tail[0, : d - full * QBLOCK]
    return x


def cosine_lr(step: int, lr: float, warmup: int, total: int, final_frac: float = 0.1) -> float:
    """Linear warm-up then a cosine decay to ``final_frac`` of ``lr``."""
    warm = min((step + 1) / max(1, warmup), 1.0)
    prog = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
    return lr * warm * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def leaves(specs) -> List[tuple]:
    """(path, offset, size) of every leaf (a block leaf stacked over its
    layers), in flat order: the units whose norms are compared."""
    out, o = [], 0
    for s in specs:
        out.append((s.path, o, s.numel))
        o += s.numel
    return out


NORM_CHUNK = 1 << 24    # elements per f64 pass of a leaf's norm


def chunked_norm(part, n: int) -> torch.Tensor:
    """The f64 norm of an n-element vector given as ``part(a, b)`` (its
    elements a..b), a chunk at a time: no f64 copy of a whole leaf."""
    acc = None
    for a in range(0, n, NORM_CHUNK):
        s = part(a, min(n, a + NORM_CHUNK)).double().square().sum()
        acc = s if acc is None else acc + s
    return acc.sqrt()


def flat_norm(x: torch.Tensor) -> float:
    """The f64 norm of a flat vector."""
    return float(chunked_norm(lambda a, b: x[a:b], x.numel()))


def leaf_norms(flat: torch.Tensor, sl) -> torch.Tensor:
    """f64 norms of the flat vector's leaves (host)."""
    return torch.stack([chunked_norm(lambda a, b, o=o: flat[o + a: o + b], n)
                        for _, o, n in sl]).cpu()


def param_views(flat: torch.Tensor, specs, grad: Optional[torch.Tensor] = None) -> Dict:
    """The model's leaves as views of ``flat``: block leaves as one view per
    layer.  With ``grad`` (a flat buffer like ``flat``) each view is a leaf
    that takes a gradient, accumulated in place into its view of ``grad``."""
    out, o = {}, 0

    def leaf(a, b, shape):
        t = flat[a:b].view(shape)
        if grad is not None:
            t.requires_grad_(True)
            t.grad = grad[a:b].view(shape)
        return t

    for s in specs:
        if s.stacked:
            per, shape = s.numel // s.shape[0], s.shape[1:]
            out[s.path] = [leaf(o + i * per, o + (i + 1) * per, shape)
                           for i in range(s.shape[0])]
        else:
            out[s.path] = leaf(o, o + s.numel, s.shape)
        o += s.numel
    return out


class Trainer:
    """The reference training step: forward and backward per group (row
    block), the sync (dense mean or EF-BV + qsgd), clip, AdamW."""

    def __init__(self, cfg: dict, specs, flat: torch.Tensor, opt: dict,
                 sync: Optional[dict], n_groups: int, fp8: bool = False):
        self.cfg, self.specs, self.opt, self.sync = cfg, specs, opt, sync
        self.n, self.fp8 = n_groups, fp8
        self.P = flat
        self.G = torch.zeros_like(flat)
        self.m = torch.zeros_like(flat)
        self.v = torch.zeros_like(flat)
        self.params = param_views(self.P, specs, self.G)
        self.efbv = sync is not None and sync["mode"] == "efbv"
        if self.efbv:
            self.h = [torch.zeros_like(flat) for _ in range(n_groups)]
            self.hbar = torch.zeros_like(flat)
            self.dsum = torch.zeros_like(flat)
            self.lam, self.nu = efbv_lambda_nu(sync["quant_bits"], n_groups)
        self.t = 0

    def _grad(self, tokens, targets, weight: float) -> torch.Tensor:
        """Accumulate ``weight * grad(loss)`` of the rows into ``G`` -> loss."""
        l = model.loss(self.params, self.cfg, tokens, targets, self.fp8, remat=True)
        (l * weight).backward()
        return l.detach()

    def step(self, tokens, targets, noise=None) -> dict:
        """One step on the batch (rows split evenly over the groups).
        ``noise(i)``: group i's draws for the quantizer (EF-BV only).
        -> {"loss", "scale"}; the optimizer's gradient is ``G * scale``."""
        self.t += 1
        B = tokens.shape[0]
        per = B // self.n
        losses = []
        if self.efbv:
            self.dsum.zero_()
            for i in range(self.n):
                self.G.zero_()
                rows = slice(i * per, (i + 1) * per)
                losses.append(self._grad(tokens[rows], targets[rows], 1.0))
                d = qsgd_(self.G.sub_(self.h[i]), noise(i), self.sync["quant_bits"])
                self.h[i].add_(d, alpha=self.lam)
                self.dsum.add_(d)
            self.dsum.div_(self.n)
            self.G.copy_(self.hbar).add_(self.dsum, alpha=self.nu)
            self.hbar.add_(self.dsum, alpha=self.lam)
        else:
            self.G.zero_()
            for r in range(B):         # the batch mean, one row at a time
                losses.append(self._grad(tokens[r: r + 1], targets[r: r + 1], 1.0 / B))
        loss = torch.stack(losses).mean()
        norm = flat_norm(self.G)
        scale = min(1.0, self.opt["grad_clip"] / (norm + 1e-9))
        self._adamw(scale)
        return {"loss": float(loss), "scale": scale}

    @torch.no_grad()
    def _adamw(self, scale: float) -> None:
        o = self.opt
        b1, b2, eps, wd = o.get("b1", 0.9), o.get("b2", 0.95), o.get("eps", 1e-8), o["weight_decay"]
        lr = cosine_lr(self.t, o["lr"], o["warmup_steps"], o["total_steps"])
        b1c, b2c = 1 - b1 ** self.t, 1 - b2 ** self.t
        off = 0
        for s in self.specs:
            for a in range(off, off + s.numel, CHUNK):
                sl = slice(a, min(off + s.numel, a + CHUNK))
                g = self.G[sl] * scale
                m, v, p = self.m[sl], self.v[sl], self.P[sl]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g.square() * (1 - b2))
                u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
                if len(s.shape) >= 2:
                    u = u + wd * p
                p.sub_(lr * u)
                if s.dtype != "float32":
                    p.copy_(p.to(getattr(torch, s.dtype)).float())
            off += s.numel
