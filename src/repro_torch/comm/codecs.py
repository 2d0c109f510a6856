"""Wire-level payload codecs (port of ``repro/comm/codecs.py``).

``encode(c, x)`` compresses ``x`` and packs the result into the planes a
transport would ship; ``decode(p)`` reconstructs the dense carrier, equal
to ``c(x)`` element for element with the same noise.  Planes are host numpy
arrays in the JAX package's exact format, so payloads cross-decode between
the two packages and ``Payload.nbytes`` — the number every ledger entry
records — is the same.

Schemes (the compressor's ``WireSpec``, or ``encode(..., scheme=)``):

  dense          the values
  sparse_idx32   uint32 global indices + f32 values
  sparse_block   per-block bitpacked local indices (ceil(log2 block) bits)
                 + f32 values + uint16 per-block counts (``topk_block``)
  sparse_bitmap  1-bit presence mask in uint32 words (kernel B4 packs it,
                 B5 unpacks it) + f32 values
  quant          int8 plane (two nibbles per byte at <= 4 bits) + f32
                 scales, axes ``flat``, ``last`` and ``kernel`` (B2 encodes,
                 B3 decodes on a CUDA device)

The data-dependent work (masks, gathers, index streams, per-tile counts)
runs on the tensor's device, the card on the main path; only the finished
planes cross to the host.  The streaming codecs split a payload into
per-tile chunks that partition its planes exactly (``split_payload``,
``encode_stream``, ``decode_stream``).
"""
from __future__ import annotations

import math
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
from repro_torch.utils.device import make_generator, resolve_device

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.int8: "int8",
              torch.int32: "int32", torch.int64: "int64",
              torch.uint8: "uint8"}
# set bits of every byte value: a popcount that needs no numpy 2 and, unlike
# np.unpackbits, no 8x expansion of a full-width mask
_POPCOUNT8 = np.array([bin(b).count("1") for b in range(256)], dtype=np.uint8)


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

    @property
    def nbits(self) -> int:
        return 8 * self.nbytes


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
# bit streams (little-endian): value i occupies bits [i*nbits, (i+1)*nbits)
# ---------------------------------------------------------------------------
_PACK_MAX_NBITS = 56  # a value shifted by its in-byte offset fits an int64


def _pack_uint_stream(vals: torch.Tensor, nbits: int) -> np.ndarray:
    """Pack unsigned ints < 2**nbits into a uint8 stream, on ``vals``'s
    device.  Each value's bits are disjoint from every other's, so adding
    the byte contributions (``index_add_``) gives the bytes the JAX
    package's ``np.bitwise_or.at`` gives."""
    n = vals.numel()
    if n == 0:
        return np.zeros((0,), np.uint8)
    if nbits > _PACK_MAX_NBITS:
        raise ValueError(f"nbits {nbits} > {_PACK_MAX_NBITS}")
    total = (n * nbits + 7) >> 3
    bitpos = torch.arange(n, dtype=torch.int64, device=vals.device) * nbits
    byte0 = bitpos >> 3
    shifted = (vals.to(torch.int64) & ((1 << nbits) - 1)) << (bitpos & 7)
    out = torch.zeros(total, dtype=torch.int32, device=vals.device)
    for b in range(((nbits + 7) >> 3) + 1):
        byte = byte0 + b
        valid = byte < total
        contrib = ((shifted >> (8 * b)) & 0xFF).to(torch.int32)
        out.index_add_(0, byte[valid], contrib[valid])
    return _host(out.to(torch.uint8))


def _unpack_uint_stream(buf: np.ndarray, n: int, nbits: int, device) -> torch.Tensor:
    """Inverse of _pack_uint_stream -> (n,) int64 on ``device``."""
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=device)
    spans = ((nbits + 7) >> 3) + 1
    bufp = F.pad(_to_device(buf, device).to(torch.int64), (0, spans))  # tail gathers
    bitpos = torch.arange(n, dtype=torch.int64, device=device) * nbits
    byte0 = bitpos >> 3
    acc = torch.zeros(n, dtype=torch.int64, device=device)
    for b in range(spans):
        acc |= bufp[byte0 + b] << (8 * b)
    return (acc >> (bitpos & 7)) & ((1 << nbits) - 1)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------
def encode(c: Compressor, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           scheme: Optional[str] = None) -> Payload:
    """Compress ``x`` with ``c`` (same ``noise``/``generator`` semantics as the
    compressor) and pack the result into its wire scheme's planes, or into
    ``scheme``'s when given."""
    with obs_trace.span("codec/encode") as sp:
        p = _encode(c, x, noise, generator, scheme)
        sp.tag(scheme=p.scheme, nbytes=p.nbytes)
    return p


def _encode(c, x, noise, generator, scheme=None) -> Payload:
    spec = c.wire or WireSpec("dense")
    scheme = scheme or spec.scheme
    if scheme == "quant" and spec.axis == "kernel":
        # B2 re-derives the planes from x with the same noise; computing the
        # dense carrier here would duplicate that pass
        return _encode_quant(None, x, spec, noise, generator)
    y = c(x, noise=noise, generator=generator)
    if scheme == "dense":
        return _encode_dense(y)
    if scheme == "sparse_idx32":
        return _encode_sparse_idx32(y)
    if scheme == "sparse_block":
        return _encode_sparse_block(y, spec.block)
    if scheme == "sparse_bitmap":
        return _encode_sparse_bitmap(y)
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
    if p.scheme == "sparse_block":
        block, nbits = p.meta.get("block"), p.meta.get("nbits")
        _require(isinstance(block, int) and block > 0, "local_indices",
                 f"bad block {block!r}")
        _require(isinstance(nbits, int) and 1 <= nbits <= _PACK_MAX_NBITS,
                 "local_indices", f"nbits {nbits!r} outside [1, {_PACK_MAX_NBITS}]")
        counts = p.planes.get("block_counts")
        _require(counts is not None, "block_counts", "missing")
        nb = -(-d // block)
        _require(counts.size == nb, "block_counts",
                 f"{counts.size} counts for {nb} blocks")
        _require(bool(np.all(counts.astype(np.int64) <= block)),
                 "block_counts", f"count exceeds block size {block}")
        k = int(counts.astype(np.int64).sum())
        vals = p.planes.get("values")
        _require(vals is not None, "values", "missing")
        _require(vals.size == k, "values", f"{vals.size} values for k={k}")
        stream = p.planes.get("local_indices")
        _require(stream is not None, "local_indices", "missing")
        want = (k * nbits + 7) >> 3
        _require(stream.nbytes == want, "local_indices",
                 f"{stream.nbytes} bytes, expected {want}")
        return
    if p.scheme == "sparse_bitmap":
        words, vals = p.planes.get("mask_words"), p.planes.get("values")
        _require(words is not None, "mask_words", "missing")
        _require(vals is not None, "values", "missing")
        dd = int(p.meta.get("d", d))
        nw = -(-dd // 32)
        _require(words.size == nw, "mask_words", f"{words.size} words for d={dd}")
        pop = int(_POPCOUNT8[np.ascontiguousarray(words).view(np.uint8)]
                  .sum(dtype=np.int64))
        _require(pop == vals.size, "values",
                 f"{vals.size} values vs {pop} set mask bits")
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
    if p.scheme == "sparse_block":
        return _decode_sparse_block(p, device).reshape(p.shape).to(dtype)
    if p.scheme == "sparse_bitmap":
        return _decode_sparse_bitmap(p, device).reshape(p.shape).to(dtype)
    if p.scheme == "quant":
        return _decode_quant(p, device).to(dtype)
    raise ValueError(f"unknown wire scheme {p.scheme!r}")


def roundtrip_equal(c: Compressor, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    seed: Optional[int] = None) -> bool:
    """decode(encode(x)) == c(x), elementwise; the carrier and the encode each
    draw from a fresh generator seeded with ``seed`` (or take ``noise``)."""
    y = c(x, noise=noise, generator=_generator(seed, x.device))
    p = encode(c, x, noise=noise, generator=_generator(seed, x.device))
    return bool((decode(p, device=x.device) == y).all())


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    return None if seed is None else make_generator(seed, device)


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


def _encode_sparse_block(y: torch.Tensor, block: int) -> Payload:
    arr = y.float().reshape(-1)
    d = arr.numel()
    nbits = max(1, math.ceil(math.log2(block)))
    nb = -(-d // block)
    idx = torch.nonzero(arr).reshape(-1)
    counts = torch.bincount(idx // block, minlength=nb)
    return Payload(
        "sparse_block", tuple(y.shape), _np_dtype(y.dtype),
        {"local_indices": _pack_uint_stream(idx % block, nbits),
         "values": _host(arr[idx]),
         "block_counts": _host(counts).astype(np.uint16)},
        {"block": block, "nbits": nbits})


def _decode_sparse_block(p: Payload, device) -> torch.Tensor:
    block, nbits = p.meta["block"], p.meta["nbits"]
    counts = _to_device(p.planes["block_counts"].astype(np.int64), device)
    local = _unpack_uint_stream(p.planes["local_indices"], int(counts.sum()), nbits,
                                device)
    base = torch.repeat_interleave(
        torch.arange(counts.numel(), dtype=torch.int64, device=device) * block, counts)
    flat = torch.zeros(int(np.prod(p.shape)), dtype=torch.float32, device=device)
    flat[base + local] = _to_device(p.planes["values"], device)
    return flat


def _encode_sparse_bitmap(y: torch.Tensor) -> Payload:
    arr = y.float().reshape(-1)
    mask = arr != 0
    words = ops.pack_bits(mask)                              # kernel B4
    return Payload("sparse_bitmap", tuple(y.shape), _np_dtype(y.dtype),
                   {"mask_words": _host(words).view(np.uint32),
                    "values": _host(arr[torch.nonzero(mask).reshape(-1)])},
                   {"d": arr.numel()})


def _bitmap_mask(p: Payload, device) -> torch.Tensor:
    """The flat (d,) uint8 presence mask of a bitmap payload (kernel B5)."""
    words = _to_device(p.planes["mask_words"].view(np.int32), device)
    return ops.unpack_bits(words, p.meta["d"])


def _decode_sparse_bitmap(p: Payload, device) -> torch.Tensor:
    # unpack restores flat order, so the set bits enumerate the kept
    # coordinates in ascending index: the order of the value plane
    mask = _bitmap_mask(p, device)
    flat = torch.zeros(p.meta["d"], dtype=torch.float32, device=device)
    flat[torch.nonzero(mask).reshape(-1)] = _to_device(p.planes["values"], device)
    return flat


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



# ---------------------------------------------------------------------------
# streaming (chunked) codecs (port of repro/comm/codecs.py:503-695)
# ---------------------------------------------------------------------------
# A Chunk is the wire unit of an overlapped transport: the payload's planes
# restricted to one tile of the flat coordinate space.  Chunks PARTITION the
# monolithic planes, so concatenating them restores every plane byte for
# byte, chunked decode equals whole-payload decode, and per-chunk ledger bytes
# sum exactly to ``Payload.nbytes``.  Tile boundaries align to each scheme's
# granule (quantizer block, QBLOCK rows, 32-bit mask words).

DEFAULT_TILE = 1 << 14  # coordinates per streamed chunk


@dataclass
class Chunk:
    """Plane slices for one tile in flight; [start, stop) is the flat
    coordinate range it carries.  Value, index, count and scale planes are
    cut at coordinate boundaries; the two bit-granular planes follow their
    byte streams (sparse_block's packed indices split at the nearest byte,
    sparse_bitmap's words keep the stride-W order), so those two reassemble
    only on concatenation (``decode_stream``), not chunk by chunk."""
    index: int
    start: int
    stop: int
    planes: Dict[str, np.ndarray]

    @property
    def nbytes(self) -> int:
        return int(sum(p.nbytes for p in self.planes.values()))

    @property
    def nbits(self) -> int:
        return 8 * self.nbytes


@dataclass
class StreamPayload:
    """A payload split into per-tile chunks (the same wire format, streamed)."""
    scheme: str
    shape: tuple
    dtype: str
    tile: int
    chunks: list
    meta: dict = field(default_factory=dict)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def nbytes(self) -> int:
        return int(sum(ch.nbytes for ch in self.chunks))

    @property
    def nbits(self) -> int:
        return 8 * self.nbytes


def _stream_granule(p: Payload) -> int:
    """Smallest coordinate step a chunk boundary may take for this scheme."""
    if p.scheme == "sparse_block":
        return p.meta["block"]
    if p.scheme == "sparse_bitmap":
        return 32
    if p.scheme == "quant":
        if p.meta["axis"] == "kernel":
            g = p.meta["qblock"]
        else:
            qshape = p.meta["qshape"]
            nsc = max(1, int(np.prod(p.meta["scale_shape"])))
            blocked = nsc * qshape[-1] == int(np.prod(qshape))
            g = qshape[-1] if blocked else 1
        if p.meta["bits"] <= 4 and g % 2:
            g *= 2  # nibble-packed plane: keep chunk splits byte-aligned
        return g
    return 1


def _quant_scale_offsets(p: Payload, elem_off: np.ndarray) -> np.ndarray:
    nsc = p.planes["scales"].shape[0]
    if p.meta["axis"] == "kernel":
        block = p.meta["qblock"]
    else:
        qshape = p.meta["qshape"]
        blocked = nsc * qshape[-1] == int(np.prod(qshape))
        if not blocked:  # a single global scale rides with the last chunk
            out = np.full(elem_off.shape, nsc, np.int64)
            out[:-1] = 0
            return out
        block = qshape[-1]
    out = np.minimum(elem_off // block, nsc)
    out[-1] = nsc
    return out


def _bitmap_kept(p: Payload, tile: int, n: int, device) -> np.ndarray:
    """Set mask bits before each tile boundary, (n+1,) int64: per-tile
    counts of the B5-unpacked mask on ``device``, then a host cumsum (the
    JAX package unpacks the words and takes a cumsum over d on the host)."""
    mask = _bitmap_mask(p, resolve_device(device))
    d = mask.numel()
    full = d // tile
    counts = mask.new_zeros(n, dtype=torch.int64)
    if full:
        counts[:full] = mask[:full * tile].view(full, tile).sum(1, dtype=torch.int64)
    if n > full:
        counts[full] = mask[full * tile:].sum(dtype=torch.int64)
    return np.concatenate([[0], np.cumsum(_host(counts))])


def _plane_offsets(p: Payload, tile: int, n: int, device) -> Dict[str, np.ndarray]:
    """Per-plane split offsets (length n+1, monotone, 0 .. plane length)."""
    d = int(np.prod(p.shape)) if p.shape else 1
    coord = np.minimum(np.arange(n + 1, dtype=np.int64) * tile, d)
    if p.scheme == "dense":
        return {"values": coord}
    if p.scheme == "sparse_idx32":
        pos = np.searchsorted(p.planes["indices"].astype(np.int64), coord)
        return {"indices": pos, "values": pos}
    if p.scheme == "sparse_block":
        block, nbits = p.meta["block"], p.meta["nbits"]
        nb = p.planes["block_counts"].shape[0]
        blocks = np.minimum(np.arange(n + 1, dtype=np.int64) * (tile // block), nb)
        blocks[-1] = nb
        kept = np.concatenate(
            [[0], np.cumsum(p.planes["block_counts"].astype(np.int64))])[blocks]
        stream_len = p.planes["local_indices"].shape[0]
        # the bitpacked stream splits at byte granularity: a straddled byte
        # rides with the later chunk; concatenation is still exact
        sbytes = np.minimum((kept * nbits) >> 3, stream_len)
        sbytes[-1] = stream_len
        return {"local_indices": sbytes, "values": kept, "block_counts": blocks}
    if p.scheme == "sparse_bitmap":
        W = p.planes["mask_words"].shape[0]
        words = np.minimum(np.arange(n + 1, dtype=np.int64) * (tile // 32), W)
        words[-1] = W
        return {"mask_words": words, "values": _bitmap_kept(p, tile, n, device)}
    if p.scheme == "quant":
        qlen = p.planes["q"].shape[0]
        qoff = np.minimum(coord >> 1 if p.meta["bits"] <= 4 else coord, qlen)
        qoff[-1] = qlen  # the padded / straddling tail rides with the last chunk
        return {"q": qoff, "scales": _quant_scale_offsets(p, coord)}
    raise ValueError(f"unknown wire scheme {p.scheme!r}")


def split_payload(p: Payload, tile: int = DEFAULT_TILE, device=None) -> StreamPayload:
    """Partition a monolithic payload into per-tile chunks (exact: chunk bytes
    sum to ``p.nbytes`` and concatenation restores every plane).  ``device``
    (``None`` -> the card) unpacks a ``sparse_bitmap`` mask to count each
    tile's values; no other scheme touches a device."""
    d = int(np.prod(p.shape)) if p.shape else 1
    g = _stream_granule(p)
    tile = max(g, (int(tile) // g) * g)
    n = max(1, -(-d // tile))
    offs = _plane_offsets(p, tile, n, device)
    chunks = []
    for t in range(n):
        with obs_trace.span("codec/encode_chunk", index=t) as csp:
            planes = {k: v[int(offs[k][t]): int(offs[k][t + 1])]
                      for k, v in p.planes.items()}
            ch = Chunk(t, min(t * tile, d), min((t + 1) * tile, d), planes)
            csp.tag(nbytes=ch.nbytes)
        chunks.append(ch)
    sp = StreamPayload(p.scheme, p.shape, p.dtype, tile, chunks, dict(p.meta))
    if sp.nbytes != p.nbytes:
        raise AssertionError(f"chunks hold {sp.nbytes} bytes of {p.nbytes} ({p.scheme})")
    return sp


def encode_stream(c: Compressor, x: torch.Tensor, tile: int = DEFAULT_TILE,
                  scheme: Optional[str] = None, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> StreamPayload:
    """Compress and pack ``x`` as the per-tile chunks a streaming transport
    ships: one monolithic encode (B2 for ``qsgd_kernel``, B4 for
    ``sparse_bitmap``), then the partition, on ``x``'s device."""
    return split_payload(encode(c, x, noise=noise, generator=generator, scheme=scheme),
                         tile, device=x.device)


def decode_stream(sp: StreamPayload, device=None) -> torch.Tensor:
    """Reassemble the chunk planes and decode, equal to ``decode``'s."""
    chunks = sorted(sp.chunks, key=lambda ch: ch.index)
    planes = {k: np.concatenate([ch.planes[k] for ch in chunks])
              for k in chunks[0].planes}
    return decode(Payload(sp.scheme, sp.shape, sp.dtype, planes, dict(sp.meta)),
                  device=device)


def stream_roundtrip_equal(c: Compressor, x: torch.Tensor, tile: int = DEFAULT_TILE,
                           noise: Optional[torch.Tensor] = None,
                           seed: Optional[int] = None) -> bool:
    """decode_stream(encode_stream(x)) == c(x), elementwise."""
    y = c(x, noise=noise, generator=_generator(seed, x.device))
    sp = encode_stream(c, x, tile=tile, noise=noise, generator=_generator(seed, x.device))
    return bool((decode_stream(sp, device=x.device) == y).all())


# ---------------------------------------------------------------------------
# size model (port of repro/comm/codecs.py:698-755)
# ---------------------------------------------------------------------------
def encoded_bits(c: Compressor, x: torch.Tensor, scheme: Optional[str] = None,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> int:
    """Exact wire bits of one message (encode and count)."""
    return encode(c, x, noise=noise, generator=generator, scheme=scheme).nbits


def extrapolate_bits(p: Payload, probe_d: int, d: int) -> float:
    """Size a payload at dimension ``d`` from a probe encoded at ``probe_d``:
    the kept-coordinate count scales from the probe, the index side (uint32
    indices, bitpacked block-local indices, block counts, mask words, scales)
    is sized from the true ``d``."""
    scale = d / probe_d
    if p.scheme == "dense":
        return 8.0 * p.planes["values"].dtype.itemsize * d
    if p.scheme == "sparse_idx32":
        k = int(round(p.planes["values"].shape[0] * scale))
        return 32.0 * k + 32.0 * k           # uint32 indices + f32 values
    if p.scheme == "sparse_block":
        block, nbits = p.meta["block"], p.meta["nbits"]
        k = int(round(p.planes["values"].shape[0] * scale))
        nb = -(-d // block)
        return (32.0 * k                      # f32 values (measured k)
                + 8.0 * ((k * nbits + 7) // 8)  # bitpacked local indices
                + 16.0 * nb)                  # uint16 per-block counts
    if p.scheme == "sparse_bitmap":
        k = int(round(p.planes["values"].shape[0] * scale))
        return 32.0 * (-(-d // 32)) + 32.0 * k  # mask words + f32 values
    if p.scheme == "quant":
        # the integer plane is block-padded linear in d; the f32 scale plane
        # counts the true d's blocks
        bits = p.meta["bits"]
        n_sc = int(p.planes["scales"].size)
        if p.meta["axis"] == "kernel":
            block = p.meta["qblock"]
        else:
            qn = int(np.prod(p.meta["qshape"]))
            block = qn // n_sc if n_sc > 1 else 0
        if block:
            n_blocks = -(-d // block)
            qd, n_scales = n_blocks * block, n_blocks
        else:
            qd, n_scales = d, 1               # a single global scale
        q_bytes = (qd + 1) // 2 if bits <= 4 else qd
        return 8.0 * q_bytes + 32.0 * n_scales
    raise ValueError(f"unknown wire scheme {p.scheme!r}")


def analytic_bits(c: Compressor, d: int) -> float:
    """The closed-form model, kept as a cross-check target."""
    return c.payload_bits(d)
