"""Compression operators (port of ``repro/core/compressors.py``).

Ported: ``identity``, ``top_k``, ``topk_block`` (the only producer of the
``sparse_block`` wire), ``qsgd`` and ``qsgd_kernel``, with ``WireSpec``,
``Compressor`` and ``scale_compressor``.  The other registry entries
(``rand_k``, ``qsgd_sharded``, ``mix_k``, ``comp_k``) come with the training
path (ROADMAP, Queue 1).

Randomness: a compressor is called as ``c(x, noise=None, generator=None)``.
A stochastic one takes its uniform draws from ``noise`` when given (how the
tests inject the JAX package's draws) or from the explicit
``torch.Generator``; with neither it raises — there is no global RNG state.
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
    fn: Callable            # (flat_x, noise, generator) -> flat_x_hat
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


def top_k(k_frac: float) -> Compressor:
    """Keep every coordinate whose magnitude is >= the k-th largest (ties
    can keep more than k, exactly as the reference's threshold compare)."""

    def fn(x, noise, gen):
        d = x.shape[0]
        k = max(1, int(round(k_frac * d)))
        thresh = torch.topk(x.abs(), k).values[-1]
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
        d = x.shape[0]
        nb = -(-d // block)
        xp = F.pad(x, (0, nb * block - d)).reshape(nb, block)
        kb = max(1, int(round(k_frac * block)))
        thresh = torch.topk(xp.abs(), kb, dim=1).values[:, -1:]
        mask = (xp.abs() >= thresh).to(x.dtype)
        return (xp * mask).reshape(-1)[:d]

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
        d = x.shape[0]
        nb = -(-d // block)
        xp = F.pad(x, (0, nb * block - d)).reshape(nb, block)
        scale = xp.abs().amax(dim=1, keepdim=True) / s
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        y = xp / scale
        if stochastic:
            y = y + _uniform(y.shape, noise, gen, x.device, low=-0.5)
        q = torch.round(y).clamp_(-s, s)
        return (q * scale).reshape(-1)[:d]

    omega = block / (4.0 * s * s)
    return Compressor(f"qsgd({bits}b,{block})", fn,
                      eta=0.0 if stochastic else None,
                      omega=omega if stochastic else None,
                      bits_per_dim=float(bits), deterministic=not stochastic,
                      wire=WireSpec("quant", block=block, bits=bits, axis="flat"))


def qsgd_kernel(bits: int = 8) -> Compressor:
    """qsgd backed by kernel B1 (``ops.quantize_dequantize``); noise shape
    (rows_pad, 512) in [0, 1)."""
    from repro_torch.kernels.ops import quantize_dequantize
    from repro_torch.kernels.quant8 import QBLOCK

    s = 2 ** (bits - 1) - 1

    def fn(x, noise, gen):
        return quantize_dequantize(x, noise=noise, generator=gen, bits=bits)

    return Compressor(f"qsgd_kernel({bits}b)", fn, eta=0.0,
                      omega=QBLOCK / (4.0 * s * s), bits_per_dim=float(bits),
                      wire=WireSpec("quant", block=QBLOCK, bits=bits, axis="kernel"))


_REGISTRY = {
    "identity": identity,
    "top_k": top_k,
    "topk_block": block_top_k,
    "qsgd": qsgd,
    "qsgd_kernel": qsgd_kernel,
}


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; known {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
