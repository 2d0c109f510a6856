"""Port streaming codecs and kernel B6 against the JAX package.

Tolerance: none.  For every wire scheme, tile and d the chunk partition
(index, coordinate range, every plane slice), ``decode_stream`` and the
``record_stream`` ledger records equal the JAX package's, and the port's
streamed payload cross-decodes through JAX's ``decode_stream``.  B6's plain
version equals the Pallas ring (interpret mode) and the port's B2, q and
scales bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.comm import codecs, ledger
from repro_torch.core import compressors as tc
from repro_torch.kernels import bitpack, ops, ref, stream
from repro_torch.kernels.ops import tile_rows

torch.set_num_threads(2)

TILES = (64, 96, 512, 4096, 1 << 16)
DS = (63, 512, 777, 4096, 5000)
# scheme id -> (compressor, its arguments, wire scheme override)
SCHEMES = {
    "dense": ("identity", {}, None),
    "sparse_idx32": ("top_k", {"k_frac": 0.05}, None),
    "sparse_bitmap": ("top_k", {"k_frac": 0.05}, "sparse_bitmap"),
    "sparse_block": ("topk_block", {"k_frac": 0.05, "block": 256}, None),
    "quant_flat": ("qsgd", {"bits": 8}, None),
    "quant_flat4": ("qsgd", {"bits": 4}, None),
    "quant_kernel": ("qsgd_kernel", {"bits": 8}, None),
    "quant_kernel4": ("qsgd_kernel", {"bits": 4}, None),
}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.comm import codecs as jcodecs
    from repro.comm import ledger as jledger
    from repro.core import compressors as jc
    return jax, jnp, jc, jcodecs, jledger


@functools.lru_cache(maxsize=None)
def _payloads(scheme_id, d):
    """(JAX payload, port payload, JAX decode) of one input, JAX's noise
    injected into the port."""
    import jax
    import jax.numpy as jnp
    from repro.comm import codecs as jcodecs
    from repro.core import compressors as jc

    name, kw, scheme = SCHEMES[scheme_id]
    rng = np.random.default_rng(d)
    x = (rng.standard_normal(d) * 3).astype(np.float32)
    x[d // 5: d // 3] = 0.0
    key = jax.random.PRNGKey(d)
    noise = None
    if name == "qsgd_kernel":
        noise = np.array(jax.random.uniform(key, (tile_rows(d), 512), jnp.float32))
    elif name == "qsgd":
        noise = np.array(jax.random.uniform(key, (-(-d // 2048), 2048), minval=-0.5,
                                            maxval=0.5))
    jp = jcodecs.encode(jc.make_compressor(name, **kw), key, jnp.asarray(x), scheme=scheme)
    tp = codecs.encode(tc.make_compressor(name, **kw), torch.from_numpy(x),
                       noise=None if noise is None else torch.from_numpy(noise),
                       scheme=scheme)
    return jp, tp, np.asarray(jcodecs.decode(jp))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("scheme_id", sorted(SCHEMES))
def test_chunks_decode_and_ledger_equal_jax(jx, scheme_id, tile, d):
    jcodecs, jledger = jx[3], jx[4]
    jp, tp, want = _payloads(scheme_id, d)
    jsp = jcodecs.split_payload(jp, tile)
    tsp = codecs.split_payload(tp, tile, device="cpu")
    assert (tsp.scheme, tsp.shape, tsp.dtype, tsp.tile, tsp.meta) == \
        (jsp.scheme, jsp.shape, jsp.dtype, jsp.tile, jsp.meta)
    assert tsp.n_chunks == jsp.n_chunks and tsp.nbytes == jsp.nbytes == tp.nbytes
    for a, b in zip(tsp.chunks, jsp.chunks):
        assert (a.index, a.start, a.stop, a.nbytes) == (b.index, b.start, b.stop, b.nbytes)
        assert sorted(a.planes) == sorted(b.planes)
        for k in b.planes:
            assert a.planes[k].tobytes() == np.asarray(b.planes[k]).tobytes(), k
    # chunk ranges tile [0, d)
    assert tsp.chunks[0].start == 0 and tsp.chunks[-1].stop == d
    assert all(a.stop == b.start for a, b in zip(tsp.chunks, tsp.chunks[1:]))
    assert codecs.decode_stream(tsp, device="cpu").numpy().tobytes() == want.tobytes()
    assert np.asarray(jcodecs.decode_stream(tsp)).tobytes() == want.tobytes()
    tl, jl = ledger.CommLedger(), jledger.CommLedger()
    trecs = tl.record_stream(3, "leaf->agg", tsp, phase=1)
    jrecs = jl.record_stream(3, "leaf->agg", jsp, phase=1)
    assert [r.__dict__ for r in trecs] == [r.__dict__ for r in jrecs]
    assert tl.total_bytes == tp.nbytes and tl.bytes_by_tag() == jl.bytes_by_tag()


@pytest.mark.parametrize("scheme_id", sorted(SCHEMES))
def test_encode_stream_and_roundtrip(scheme_id):
    """encode_stream == split_payload(encode(...)); decode_stream == the
    compressor's carrier (noise-free schemes through a seed)."""
    name, kw, scheme = SCHEMES[scheme_id]
    comp = tc.make_compressor(name, **kw)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(3000).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(4)
    sp = codecs.encode_stream(comp, x, tile=512, scheme=scheme, generator=gen())
    p = codecs.encode(comp, x, generator=gen(), scheme=scheme)
    assert sp.nbytes == p.nbytes
    assert all(np.array_equal(np.concatenate([c.planes[k] for c in sp.chunks]), p.planes[k])
               for k in p.planes)
    assert bool((codecs.decode_stream(sp, device="cpu") == comp(x, generator=gen())).all())
    if scheme is None:
        assert codecs.stream_roundtrip_equal(comp, x, tile=512, seed=4)


def test_split_payload_spans_when_tracing():
    from repro_torch.obs import trace

    p = codecs.encode(tc.make_compressor("identity"), torch.ones(100))
    tracer = trace.get_tracer()
    was = trace.enabled()
    tracer.reset()
    trace.enable()
    try:
        sp = codecs.split_payload(p, tile=32, device="cpu")
    finally:
        if not was:
            trace.disable()
    spans = [s for s in tracer.spans() if s.name == "codec/encode_chunk"]
    assert [s.tags for s in spans] == [{"index": c.index, "nbytes": c.nbytes} for c in sp.chunks]
    tracer.reset()


@pytest.mark.parametrize("rows", [8, 40])
def test_plain_stream_kernel_equals_jax_ring_and_b2(jx, rows):
    """B6's plain version == the Pallas ring (interpret mode) == the port's
    B2, q and scales bit for bit (the kernels' scale rule, absmax * f32(1/s))."""
    from repro.kernels import stream as jstream

    jnp = jx[1]
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 512)) * 7).astype(np.float32)
    x[rows // 2] = 0.0
    u = rng.random((rows, 512), dtype=np.float32)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    q, s = stream.stream_quant_pack_2d(tx, tu)
    jq, js = jstream.stream_quant_pack_2d(jnp.asarray(x), jnp.asarray(u))
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    q2, s2 = bitpack.quant_pack_2d(tx, tu)
    assert torch.equal(q, q2) and s.numpy().tobytes() == s2.numpy().tobytes()
    for tile in (8, 16, 24, 1 << 16):                  # tiling cannot change a bit
        qt, st = ref.stream_quant_pack_ref(tx, tu, tile_rows=tile)
        assert torch.equal(qt, q) and st.numpy().tobytes() == s.numpy().tobytes()


@pytest.mark.parametrize("d", [511, 3000, 4097])
def test_stream_quantize_pack_equals_quantize_pack_and_jax(jx, d):
    """ops.stream_quantize_pack: the same padding and noise as quantize_pack
    (JAX's draw injected), so the planes equal JAX's stream_quantize_pack."""
    from repro.kernels import ops as jops

    jax, jnp = jx[0], jx[1]
    x = (np.random.default_rng(d).standard_normal(d) * 4).astype(np.float32)
    key = jax.random.PRNGKey(d + 1)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (tile_rows(d), 512),
                                                         jnp.float32)))
    q, s = ops.stream_quantize_pack(torch.from_numpy(x), noise=noise)
    q1, s1 = ops.quantize_pack(torch.from_numpy(x), noise=noise)
    jq, js = jops.stream_quantize_pack(jnp.asarray(x), key)
    assert torch.equal(q, q1) and torch.equal(s, s1)
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
