"""Wire-level payload codecs (port of ``repro/comm/codecs.py:43-330,
390-500``).

``encode(c, x)`` compresses ``x`` and packs the result into the planes a
transport would ship; ``decode(p)`` reconstructs the dense carrier, equal
bit for bit to ``c(x)`` with the same noise.  Planes are host numpy arrays in
the JAX package's exact format, so payloads cross-decode between the two
packages and ``Payload.nbytes`` — the number every ledger entry records — is
the same.

Schemes in this slice: ``dense``, ``sparse_idx32`` and ``quant`` with axes
``flat``, ``last`` and ``kernel``.  The ``kernel`` axis encodes through
kernel B2 and, on a CUDA device, decodes through kernel B3.
``sparse_block``, ``sparse_bitmap`` and the streaming codecs come with the
training slice.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.compressors import Compressor, WireSpec
from repro_torch.kernels import ops
from repro_torch.kernels.quant8 import TILE_ROWS
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import resolve_device

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int8: "int8",
              torch.int32: "int32", torch.int64: "int64",
              torch.uint8: "uint8"}


class PayloadError(ValueError):
    """A wire payload failed validation; ``plane`` names the bad buffer."""

    def __init__(self, plane: str, message: str):
        self.plane = plane
        super().__init__(f"plane {plane!r}: {message}")


@dataclass
class Payload:
    """One encoded tensor as it would sit in a transport buffer.

    ``planes`` are the wire buffers (numpy, final dtypes); ``nbytes`` is their
    exact total.  Header fields (shape, scheme, gain) live in ``meta`` and are
    not counted, as in the JAX package.
    """
    scheme: str
    shape: tuple
    dtype: str
    planes: Dict[str, np.ndarray]
    meta: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(sum(p.nbytes for p in self.planes.values()))


def _np_dtype(dtype: torch.dtype) -> str:
    if dtype not in _NP_DTYPES:
        raise NotImplementedError(f"no wire dtype for {dtype}")
    return _NP_DTYPES[dtype]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    if not arr.flags.writeable:      # e.g. planes made by the JAX package
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------
def encode(c: Compressor, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> Payload:
    """Compress ``x`` with ``c`` (same ``noise``/``generator`` semantics as the
    compressor) and pack the result into its wire scheme's planes."""
    with obs_trace.span("codec/encode") as sp:
        p = _encode(c, x, noise, generator)
        sp.tag(scheme=p.scheme, nbytes=p.nbytes)
    return p


def _encode(c, x, noise, generator) -> Payload:
    spec = c.wire or WireSpec("dense")
    scheme = spec.scheme
    if scheme == "quant" and spec.axis == "kernel":
        # B2 re-derives the planes from x with the same noise; computing the
        # dense carrier here would duplicate that pass
        return _encode_quant(None, x, spec, noise, generator)
    y = c(x, noise=noise, generator=generator)
    if scheme == "dense":
        return _encode_dense(y)
    if scheme == "sparse_idx32":
        return _encode_sparse_idx32(y)
    if scheme == "quant":
        return _encode_quant(y, x, spec, noise, generator)
    raise ValueError(f"unknown wire scheme {scheme!r}")


def _require(cond: bool, plane: str, message: str) -> None:
    if not cond:
        raise PayloadError(plane, message)


def validate_payload(p: Payload) -> None:
    """Check plane lengths / bounds before any slicing; raise
    ``PayloadError`` naming the offending plane."""
    d = int(np.prod(p.shape)) if p.shape else 1
    if p.scheme == "dense":
        v = p.planes.get("values")
        _require(v is not None, "values", "missing")
        _require(v.size == d, "values", f"{v.size} values for shape {p.shape}")
        return
    if p.scheme == "sparse_idx32":
        idx, vals = p.planes.get("indices"), p.planes.get("values")
        _require(idx is not None, "indices", "missing")
        _require(vals is not None, "values", "missing")
        _require(idx.size == vals.size, "indices",
                 f"{idx.size} indices vs {vals.size} values")
        if idx.size:
            _require(int(idx.max()) < d, "indices",
                     f"index {int(idx.max())} out of range for d={d}")
        return
    if p.scheme == "quant":
        bits = p.meta.get("bits")
        _require(isinstance(bits, int) and 1 <= bits <= 8, "q",
                 f"bits {bits!r} outside [1, 8]")
        q, scales = p.planes.get("q"), p.planes.get("scales")
        _require(q is not None, "q", "missing")
        _require(scales is not None, "scales", "missing")
        if p.meta.get("axis") == "kernel":
            rows, qb = p.meta["rows"], p.meta["qblock"]
            kept = _q_keep(int(p.meta["d"]), (rows, qb))
            want = (kept + 1) // 2 if bits <= 4 else kept
            _require(q.nbytes == want, "q", f"{q.nbytes} bytes, expected {want}")
            _require(scales.size == rows, "scales",
                     f"{scales.size} scales for {rows} rows")
            return
        n = int(np.prod(p.meta["qshape"]))
        want = (n + 1) // 2 if bits <= 4 else n
        _require(q.nbytes == want, "q", f"{q.nbytes} bytes, expected {want}")
        nsc = int(np.prod(p.meta["scale_shape"]))
        _require(scales.size == nsc, "scales",
                 f"{scales.size} scales, expected {nsc}")
        return
    raise PayloadError("<scheme>", f"unknown wire scheme {p.scheme!r}")


def seal_payload(p: Payload) -> Payload:
    """Stamp a CRC32 per plane into ``meta['crc32']``."""
    p.meta["crc32"] = {k: zlib.crc32(np.ascontiguousarray(v).view(np.uint8))
                       for k, v in p.planes.items()}
    return p


def verify_payload(p: Payload) -> None:
    """Recompute plane checksums against the sealed header."""
    sums = p.meta.get("crc32")
    if sums is None:
        return
    for k, v in p.planes.items():
        if k not in sums:
            raise PayloadError(k, "no checksum in sealed header")
        got = zlib.crc32(np.ascontiguousarray(v).view(np.uint8))
        if got != sums[k]:
            raise PayloadError(
                k, f"checksum mismatch (got {got:#010x}, sealed {sums[k]:#010x})")


def decode(p: Payload, device=None) -> torch.Tensor:
    """Reconstruct the dense compressed carrier on ``device`` (``None`` ->
    the card).  Validates lengths and checksums first."""
    device = resolve_device(device)
    with obs_trace.span("codec/decode", scheme=p.scheme, nbytes=p.nbytes):
        validate_payload(p)
        verify_payload(p)
        return _decode(p, device)


def _decode(p: Payload, device) -> torch.Tensor:
    dtype = getattr(torch, p.dtype)
    if p.scheme == "dense":
        vals = p.planes["values"].astype(p.meta.get("plane_dtype", p.dtype))
        return _to_device(vals, device).reshape(p.shape).to(dtype)
    if p.scheme == "sparse_idx32":
        flat = torch.zeros(int(np.prod(p.shape)), dtype=torch.float32,
                           device=device)
        idx = _to_device(p.planes["indices"].astype(np.int64), device)
        flat[idx] = _to_device(p.planes["values"], device)
        return flat.reshape(p.shape).to(dtype)
    if p.scheme == "quant":
        return _decode_quant(p, device).to(dtype)
    raise ValueError(f"unknown wire scheme {p.scheme!r}")


# ---------------------------------------------------------------------------
# per-scheme implementations
# ---------------------------------------------------------------------------
def _encode_dense(y: torch.Tensor) -> Payload:
    name = _np_dtype(y.dtype)
    return Payload("dense", tuple(y.shape), name, {"values": _host(y.reshape(-1))},
                   {"plane_dtype": name})


def _encode_sparse_idx32(y: torch.Tensor) -> Payload:
    arr = y.float().reshape(-1)
    idx = torch.nonzero(arr).reshape(-1)
    return Payload("sparse_idx32", tuple(y.shape), _np_dtype(y.dtype),
                   {"indices": _host(idx).astype(np.uint32),
                    "values": _host(arr[idx])})


def _quant_scales(x: torch.Tensor, spec: WireSpec):
    """The compressor's per-block scales from the input tensor (true
    division by s, as the JAX package's eager ``qsgd`` computes them)."""
    s = 2 ** (spec.bits - 1) - 1
    if spec.axis == "last":
        last = x.shape[-1] if x.dim() else 1
        if x.dim() >= 1 and last % spec.block == 0:
            shaped = x.reshape(x.shape[:-1] + (last // spec.block, spec.block))
            scale = shaped.abs().amax(dim=-1, keepdim=True) / s
        else:
            shaped = x
            scale = x.abs().amax() / s
        return torch.where(scale == 0, torch.ones_like(scale), scale), tuple(shaped.shape)
    flat = x.reshape(-1)
    d = flat.shape[0]
    nb = -(-d // spec.block)
    xp = F.pad(flat, (0, nb * spec.block - d)).reshape(nb, spec.block)
    scale = xp.abs().amax(dim=1, keepdim=True) / s
    return torch.where(scale == 0, torch.ones_like(scale), scale), (nb, spec.block)


def _store_q(q: torch.Tensor, bits: int) -> np.ndarray:
    if bits <= 4:
        return _host(ops.nibble_pack(q))
    return _host(q.to(torch.int8))


def _load_q(plane: np.ndarray, bits: int, n: int, device) -> torch.Tensor:
    t = _to_device(plane, device)
    return ops.nibble_unpack(t, n) if bits <= 4 else t


def _encode_quant(y, x, spec: WireSpec, noise, generator) -> Payload:
    if spec.axis == "kernel":
        # kernel B2: same padding + noise as the compressor's
        # quantize_dequantize, so q * scales == y bit for bit
        q, scales = ops.quantize_pack(x, noise=noise, generator=generator,
                                      bits=spec.bits)
        d = x.numel()
        kept = _q_keep(d, q.shape)
        rows_used = kept // q.shape[1]
        # the plane is TILE_ROWS-padded; ship only rows that carry data
        return Payload(
            "quant", tuple(x.shape), _np_dtype(x.dtype),
            {"q": _store_q(q.reshape(-1)[:kept], spec.bits),
             "scales": _host(scales.reshape(-1)[:rows_used])},
            {"bits": spec.bits, "axis": "kernel", "gain": spec.gain,
             "rows": rows_used, "qblock": q.shape[1], "d": d})
    # the integer plane from the dense carrier: y = gain * q * scale, so
    # rint(y / (gain * scale)) recovers q exactly
    scale, shaped = _quant_scales(x, spec)
    y_shaped = _pad_like(y.float(), spec, shaped)
    s = 2 ** (spec.bits - 1) - 1
    q = torch.round(y_shaped / (scale * spec.gain)).clamp_(-s, s).to(torch.int8)
    return Payload(
        "quant", tuple(y.shape), _np_dtype(y.dtype),
        {"q": _store_q(q.reshape(-1), spec.bits),
         "scales": _host(scale.float().reshape(-1))},
        {"bits": spec.bits, "axis": spec.axis, "gain": spec.gain,
         "qshape": tuple(q.shape), "scale_shape": tuple(scale.shape),
         "d": y.numel()})


def _q_keep(d: int, qshape) -> int:
    rows_used = -(-d // qshape[1])
    return rows_used * qshape[1]


def _pad_like(y: torch.Tensor, spec: WireSpec, shaped) -> torch.Tensor:
    if spec.axis == "last":
        return y.reshape(shaped)
    d = y.numel()
    nb, block = shaped
    return F.pad(y.reshape(-1), (0, nb * block - d)).reshape(nb, block)


def _pad_rows(q: torch.Tensor, scales: torch.Tensor):
    """Pad (rows, qb) planes to whole TILE_ROWS tiles for kernel B3 (zero q,
    unit scale); a no-op, without a copy, when rows already fill tiles."""
    rows = q.shape[0]
    rows_pad = -(-rows // TILE_ROWS) * TILE_ROWS
    if rows_pad == rows:
        return q, scales
    qp = q.new_zeros((rows_pad, q.shape[1]))
    qp[:rows] = q
    sp = scales.new_ones((rows_pad, 1))
    sp[:rows] = scales
    return qp, sp


def _decode_quant(p: Payload, device) -> torch.Tensor:
    d, gain, bits = p.meta["d"], p.meta["gain"], p.meta["bits"]
    if p.meta["axis"] == "kernel":
        rows, qb = p.meta["rows"], p.meta["qblock"]
        kept = _q_keep(d, (rows, qb))
        q = _load_q(p.planes["q"], bits, kept, device).reshape(rows, qb)
        scales = _to_device(p.planes["scales"], device).reshape(rows, 1)
        out = ops.unpack_dequantize(*_pad_rows(q, scales), d)
        if gain != 1.0:
            out = gain * out
        return out.reshape(p.shape)
    qshape = p.meta["qshape"]
    n = int(np.prod(qshape))
    q = _load_q(p.planes["q"], bits, n, device).reshape(qshape).float()
    out = q * _to_device(p.planes["scales"], device).reshape(p.meta["scale_shape"])
    if gain != 1.0:
        out = gain * out
    if p.meta["axis"] == "last":
        return out.reshape(p.shape)
    return out.reshape(-1)[:d].reshape(p.shape)

