"""Compression operators and the C(eta, omega) calculus (port of
``repro/core/compressors.py``).

Every registry entry: ``identity``, ``rand_k``, ``top_k``, ``topk_block``
(the only producer of the ``sparse_block`` wire), ``qsgd``, ``qsgd_sharded``
(last-axis blocks, the runtime ``qsgd``), ``qsgd_kernel`` (kernel B1),
``mix_k`` and ``comp_k``; the scalings ``lambda_star``/``nu_star``
(Prop 2.2.2), ``efbv_rates``/``efbv_stepsize`` (Sect. 2.4),
``estimate_eta_omega`` and ``tree_compress``.

Randomness: a compressor is called as ``c(x, noise=None, generator=None)``.
A stochastic one takes its uniform draws from ``noise`` when given (how the
tests inject the JAX package's draws) or from the explicit
``torch.Generator``; with neither it raises — there is no global RNG state.
The draws, as the JAX compressor makes them:

  rand_k, comp_k   scores (d,) in [0, 1)
  qsgd             (nb, block) in [-0.5, 0.5)
  qsgd_sharded     the blocked shape of x (``y.shape``) in [0, 1)
  qsgd_kernel      (rows_pad, 512) in [0, 1)
  mix_k            a tuple (coin (), scores (d,)), both in [0, 1): the
                   coin picks top-k when < rho (its branch draws nothing)

Sparsifiers keep every coordinate at or above the k-th value (ties can keep
more than k), rand_k every score at or below the k-th smallest, exactly as
the reference's threshold compares.

Row-wise: ``fn`` of every flattenable compressor works along the last axis
of any-rank input, each row exactly as a 1-D call on it (the draws above get
the same leading dimensions; mix_k's coin one per row), so a stack of (G, d)
rows compresses in one batched pass.  ``Compressor.__call__`` flattens first,
so called on a tensor it compresses the whole tensor as one vector.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class WireSpec:
    """How a compressor's output is packed on the wire (``comm.codecs``).

    scheme: dense | sparse_idx32 | sparse_block | sparse_bitmap | quant
    (any sparsifier may opt into ``sparse_bitmap``, a 1-bit presence mask
    packed by kernel B4); block/bits: quantizer or sparse-block blocking;
    axis: "flat", "last" or "kernel" (the B2 quantize-pack layout).
    ``gain`` is a post-scale applied by scale_compressor.
    """
    scheme: str = "dense"
    block: int = 0
    bits: int = 32
    axis: str = "flat"
    gain: float = 1.0


@dataclass(frozen=True)
class Compressor:
    name: str
    fn: Callable            # (x (..., d), noise, generator) -> x_hat, row-wise
    eta: Optional[float]
    omega: Optional[float]
    bits_per_dim: float
    deterministic: bool = False
    flatten: bool = True
    wire: Optional[WireSpec] = None

    def __call__(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.flatten:
            return self.fn(x, noise, generator)
        return self.fn(x.reshape(-1), noise, generator).reshape(x.shape)

    def payload_bits(self, d: int) -> float:
        """The closed-form wire size the JAX package's seed modelled."""
        return self.bits_per_dim * d

    def contractive_alpha(self) -> Optional[float]:
        """1 - (eta^2 + omega) when < 1 (Eq. 2.3); None otherwise."""
        if self.eta is None or self.omega is None:
            return None
        r = self.eta**2 + self.omega
        return (1.0 - r) if r < 1 else None


def scale_compressor(c: Compressor, lam: float) -> Compressor:
    """lam * C (Prop 2.2.1): eta' = lam*eta + 1 - lam, omega' = lam^2 omega."""
    eta = None if c.eta is None else lam * c.eta + (1.0 - lam)
    omega = None if c.omega is None else lam**2 * c.omega
    wire = c.wire if c.wire is None else replace(c.wire, gain=c.wire.gain * lam)
    return Compressor(
        name=f"scale({c.name},{lam:.4g})",
        fn=lambda x, noise, gen, c=c, lam=lam: lam * c.fn(x, noise, gen),
        eta=eta, omega=omega, bits_per_dim=c.bits_per_dim,
        deterministic=c.deterministic, flatten=c.flatten, wire=wire)


def lambda_star(eta: float, omega: float) -> float:
    return min((1.0 - eta) / ((1.0 - eta) ** 2 + omega), 1.0)


def nu_star(eta: float, omega_ran: float) -> float:
    return min((1.0 - eta) / ((1.0 - eta) ** 2 + omega_ran), 1.0)


def omega_ran_independent(omega: float, n: int) -> float:
    """Independent randomness across n workers: omega_ran = omega / n."""
    return omega / n


def efbv_rates(eta: float, omega: float, omega_ran: float, lam: float, nu: float):
    """r, r_av, s*, theta* from Sect. 2.4 (used for stepsize selection)."""
    r = (1 - lam + lam * eta) ** 2 + lam**2 * omega
    r_av = (1 - nu + nu * eta) ** 2 + nu**2 * omega_ran
    s_star = math.sqrt((1 + r) / (2 * r)) - 1
    theta_star = s_star * (1 + s_star) * r / max(r_av, 1e-30)
    return r, r_av, s_star, theta_star


def efbv_stepsize(L: float, L_tilde: float, eta: float, omega: float,
                  omega_ran: float, lam: float, nu: float) -> float:
    """Upper bound of Thm 2.4.1: gamma <= 1 / (L + L~ sqrt(r_av/r)/s*)."""
    r, r_av, s_star, _ = efbv_rates(eta, omega, omega_ran, lam, nu)
    if r >= 1 or s_star <= 0:
        return 1.0 / (2 * L)
    return 1.0 / (L + L_tilde * math.sqrt(r_av / r) / s_star)


def _uniform(shape, noise, generator, device, low: float = 0.0):
    """Uniform draws in [low, low + 1): the injected ``noise`` or fresh ones."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)}, expected "
                             f"{tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("stochastic compressor needs noise= or generator=")
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u.add_(low) if low else u


def identity() -> Compressor:
    return Compressor("identity", lambda x, noise, gen: x, eta=0.0, omega=0.0,
                      bits_per_dim=32.0, deterministic=True,
                      wire=WireSpec("dense"))


def _kth_smallest(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(scores, k, dim=-1, largest=False).values[..., -1:]


def rand_k(k_frac: float) -> Compressor:
    """Keep every coordinate whose score is <= the k-th smallest of d uniform
    scores, scaled by d/k (unbiased)."""

    def fn(x, noise, gen):
        d = x.shape[-1]
        k = max(1, int(round(k_frac * d)))
        scores = _uniform(x.shape, noise, gen, x.device)
        mask = (scores <= _kth_smallest(scores, k)).to(x.dtype)
        return x * mask * (d / k)

    omega = 1.0 / k_frac - 1.0
    return Compressor(f"rand_k({k_frac:g})", fn, eta=0.0, omega=omega,
                      bits_per_dim=k_frac * (32 + 32),
                      wire=WireSpec("sparse_idx32"))


def top_k(k_frac: float) -> Compressor:
    """Keep every coordinate whose magnitude is >= the k-th largest (ties
    can keep more than k, exactly as the reference's threshold compare)."""

    def fn(x, noise, gen):
        d = x.shape[-1]
        k = max(1, int(round(k_frac * d)))
        thresh = torch.topk(x.abs(), k, dim=-1).values[..., -1:]
        return x * (x.abs() >= thresh).to(x.dtype)

    eta = math.sqrt(max(0.0, 1.0 - k_frac))
    return Compressor(f"top_k({k_frac:g})", fn, eta=eta, omega=0.0,
                      bits_per_dim=k_frac * (32 + 32), deterministic=True,
                      wire=WireSpec("sparse_idx32"))


def block_top_k(k_frac: float, block: int = 2048) -> Compressor:
    """Top-k within contiguous blocks of ``block`` coordinates: in each block
    keep every coordinate whose magnitude is >= the block's kb-th largest,
    kb = round(k_frac * block) (the zero-padded tail block included)."""

    def fn(x, noise, gen):
        d = x.shape[-1]
        nb = -(-d // block)
        xp = F.pad(x, (0, nb * block - d)).reshape(*x.shape[:-1], nb, block)
        kb = max(1, int(round(k_frac * block)))
        thresh = torch.topk(xp.abs(), kb, dim=-1).values[..., -1:]
        mask = (xp.abs() >= thresh).to(x.dtype)
        return (xp * mask).reshape(*x.shape[:-1], -1)[..., :d]

    eta = math.sqrt(max(0.0, 1.0 - k_frac))
    return Compressor(f"block_top_k({k_frac:g},{block})", fn, eta=eta, omega=0.0,
                      bits_per_dim=k_frac * (32 + math.log2(block)),
                      deterministic=True,
                      wire=WireSpec("sparse_block", block=block))


def qsgd(bits: int = 8, block: int = 2048, stochastic: bool = True) -> Compressor:
    """Blockwise absmax s-level quantizer; ``round(y + u)`` with u in
    [-0.5, 0.5), so stochastic rounding is unbiased.  Noise shape (nb, block)."""
    s = 2 ** (bits - 1) - 1

    def fn(x, noise, gen):
        d = x.shape[-1]
        nb = -(-d // block)
        xp = F.pad(x, (0, nb * block - d)).reshape(*x.shape[:-1], nb, block)
        scale = xp.abs().amax(dim=-1, keepdim=True) / s
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        y = xp / scale
        if stochastic:
            y = y + _uniform(y.shape, noise, gen, x.device, low=-0.5)
        q = torch.round(y).clamp_(-s, s)
        return (q * scale).reshape(*x.shape[:-1], -1)[..., :d]

    omega = block / (4.0 * s * s)
    return Compressor(f"qsgd({bits}b,{block})", fn,
                      eta=0.0 if stochastic else None,
                      omega=omega if stochastic else None,
                      bits_per_dim=float(bits), deterministic=not stochastic,
                      wire=WireSpec("quant", block=block, bits=bits, axis="flat"))


def mix_k(k_frac_top: float, k_frac_rand: float, rho: float = 0.5) -> Compressor:
    """mix-(k,k') (App. A.1.1): top-k with prob rho, rand-k' with prob 1-rho.
    Both branches are computed, as the reference's ``where`` does."""
    t = top_k(k_frac_top)
    r = rand_k(k_frac_rand)

    def fn(x, noise, gen):
        if noise is None:
            coin_u = _uniform(x.shape[:-1], None, gen, x.device)
            scores = _uniform(x.shape, None, gen, x.device)
        else:
            coin_u, scores = noise
        coin = _uniform(x.shape[:-1], coin_u, gen, x.device)[..., None] < rho
        return torch.where(coin, t.fn(x, None, None), r.fn(x, scores, None))

    bits = rho * t.bits_per_dim + (1 - rho) * r.bits_per_dim
    return Compressor(f"mix({k_frac_top:g},{k_frac_rand:g},{rho:g})", fn,
                      eta=None, omega=None, bits_per_dim=bits,
                      wire=WireSpec("sparse_idx32"))


def comp_k(k_frac_top: float, k_frac_rand: float) -> Compressor:
    """comp-(k,k') (App. A.1.2): top-k applied to the output of rand-k'
    (random support of size k', then the k largest among it, unscaled)."""

    def fn(x, noise, gen):
        d = x.shape[-1]
        kr = max(1, int(round(k_frac_rand * d)))
        kt = max(1, int(round(k_frac_top * d)))
        scores = _uniform(x.shape, noise, gen, x.device)
        sel = scores <= _kth_smallest(scores, kr)
        masked = torch.where(sel, x.abs(), torch.full_like(x, -math.inf))
        thresh_t = torch.topk(masked, kt, dim=-1).values[..., -1:]
        return x * (masked >= thresh_t).to(x.dtype)

    return Compressor(f"comp({k_frac_top:g},{k_frac_rand:g})", fn,
                      eta=None, omega=None,
                      bits_per_dim=k_frac_top * (32 + 32),
                      wire=WireSpec("sparse_idx32"))


def qsgd_sharded(bits: int = 8, block: int = 256, stochastic: bool = True) -> Compressor:
    """qsgd with blocks along the LAST axis only (no flatten); one scalar
    scale per leaf when the last dim does not block evenly.  Stochastic
    rounding is ``floor(y + u)`` with u in [0, 1) of the blocked shape."""
    s = 2 ** (bits - 1) - 1

    def fn(x, noise, gen):
        last = x.shape[-1] if x.dim() else 1
        if x.dim() >= 1 and last % block == 0:
            shaped = x.reshape(x.shape[:-1] + (last // block, block))
            scale = shaped.abs().amax(dim=-1, keepdim=True) / s
        else:
            shaped = x
            scale = x.abs().amax() / s
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        y = shaped / scale
        if stochastic:
            q = torch.floor(y + _uniform(y.shape, noise, gen, x.device))
        else:
            q = torch.round(y)
        return (q.clamp_(-s, s) * scale).reshape(x.shape)

    return Compressor(f"qsgd_sharded({bits}b,{block})", fn,
                      eta=0.0 if stochastic else None,
                      omega=block / (4.0 * s * s) if stochastic else None,
                      bits_per_dim=float(bits), flatten=False,
                      wire=WireSpec("quant", block=block, bits=bits, axis="last"))


def qsgd_kernel(bits: int = 8) -> Compressor:
    """qsgd backed by kernel B1 (``ops.quantize_dequantize``); noise shape
    (rows_pad, 512) in [0, 1) per row."""
    from repro_torch.kernels.ops import quantize_dequantize, tile_rows
    from repro_torch.kernels.quant8 import QBLOCK

    s = 2 ** (bits - 1) - 1

    def fn(x, noise, gen):
        if x.dim() == 1:
            return quantize_dequantize(x, noise=noise, generator=gen, bits=bits)
        # rows: each padded to whole tiles on its own, as a 1-D call pads it,
        # so one launch over all rows equals one call per row (noise
        # (..., rows_pad, 512))
        d = x.shape[-1]
        xp = F.pad(x, (0, tile_rows(d) * QBLOCK - d))
        u = None if noise is None else noise.reshape(-1, QBLOCK)
        return quantize_dequantize(xp, noise=u, generator=gen, bits=bits)[..., :d]

    return Compressor(f"qsgd_kernel({bits}b)", fn, eta=0.0,
                      omega=QBLOCK / (4.0 * s * s), bits_per_dim=float(bits),
                      wire=WireSpec("quant", block=QBLOCK, bits=bits, axis="kernel"))


_REGISTRY = {
    "identity": identity,
    "rand_k": rand_k,
    "top_k": top_k,
    "topk_block": block_top_k,
    "qsgd": qsgd,
    "qsgd_sharded": qsgd_sharded,
    "qsgd_kernel": qsgd_kernel,
    "mix_k": mix_k,
    "comp_k": comp_k,
}


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; known {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


# ---------------------------------------------------------------------------
# Empirical (eta, omega) estimation, for operators without a closed form
# ---------------------------------------------------------------------------
def estimate_eta_omega(c: Compressor, generator: torch.Generator, dim: int,
                       n_vectors: int = 16, n_samples: int = 64) -> tuple:
    """Empirical sup over heavy-tailed test vectors of relative bias and
    variance; every draw comes from ``generator``."""
    dev = generator.device
    xs = torch.randn((n_vectors, dim), generator=generator, device=dev)
    xs = xs * torch.exp(2.0 * torch.randn((n_vectors, dim), generator=generator,
                                          device=dev))
    biases, variances = [], []
    for x in xs:
        ys = torch.stack([c(x, generator=generator) for _ in range(n_samples)])
        mean = ys.mean(dim=0)
        biases.append(float(torch.linalg.norm(mean - x) / (torch.linalg.norm(x) + 1e-12)))
        variances.append(float(((ys - mean) ** 2).sum(dim=-1).mean()
                               / ((x**2).sum() + 1e-12)))
    return max(biases), max(variances)


def tree_compress(c: Compressor, tree, noise=None, generator=None):
    """``c`` on every leaf; ``noise`` (optional) is one draw per leaf, in
    the tree's flatten order."""
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    noise = noise if noise is not None else [None] * len(leaves)
    return tree_unflatten(treedef, [c(leaf, noise=n, generator=generator)
                                    for leaf, n in zip(leaves, noise)])
