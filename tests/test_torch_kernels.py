"""Port kernels B1-B6: plain versions vs the JAX Pallas kernels, and the
CUDA kernels vs the plain versions on the card.

Parity tolerance: none — every comparison is bitwise.  The JAX side runs the
Pallas kernels in interpret mode, as the JAX package's own tests do; inputs
and noise are made from a seed with numpy (``ops`` tests draw the noise with
``jax.random.uniform(key, padded.shape)`` and inject it into the port).
Tests marked ``cuda`` need an NVIDIA card and skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import bitpack, build, ops, quant8, ref, stream

torch.set_num_threads(2)
QUANT = ("quant_dequant_2d", "quant_pack_2d", "unpack_dequant_2d")   # B1-B3
MASK_D = (1, 31, 32, 33, 4097, 4101)                                 # B4/B5 ragged d


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.kernels import bitpack as jbp
    from repro.kernels import ops as jops
    from repro.kernels import quant8 as jq8
    return jax, jnp, jq8, jbp, jops


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _tiles(rows=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 512))
         * rng.uniform(1e-3, 50.0, (rows, 1))).astype(np.float32)
    x[3] = 0.0
    x[rows - 2] = 0.0
    u = rng.random((rows, 512), dtype=np.float32)
    return x, u


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_kernels_bitwise_equal_jax_interpret(jx, bits):
    jax, jnp, jq8, jbp, _ = jx
    x, u = _tiles(seed=bits)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    out = quant8.quant_dequant_2d(tx, tu, bits)
    q, s = bitpack.quant_pack_2d(tx, tu, bits)
    deq = bitpack.unpack_dequant_2d(q, s)
    jout = jq8.quant_dequant_2d(jnp.asarray(x), jnp.asarray(u), bits=bits)
    jq, js = jbp.quant_pack_2d(jnp.asarray(x), jnp.asarray(u), bits=bits)
    jdeq = jbp.unpack_dequant_2d(jq, js)
    assert _bits(out.numpy()) == _bits(jout)
    assert _bits(q.numpy()) == _bits(jq)
    assert _bits(s.numpy()) == _bits(js)
    assert _bits(deq.numpy()) == _bits(jdeq)
    assert _bits(deq.numpy()) == _bits(out.numpy())      # B3(B2) == B1


def test_scale_rule_follows_the_pallas_kernels_not_ref(jx):
    """absmax * f32(1/s), not absmax / s: the rows where the two roundings
    differ must take the kernels' value."""
    x, u = _tiles(rows=256, seed=3)
    amax = np.abs(x).max(axis=1).astype(np.float32)
    s = np.float32(127)
    by_div = amax / s
    by_recip = amax * (np.float32(1) / s)
    differ = by_div != by_recip
    assert differ.any()                      # the input exercises the gap
    _, scales = bitpack.quant_pack_2d(torch.from_numpy(x), torch.from_numpy(u), 8)
    got = scales.numpy()[:, 0]
    nz = amax != 0
    assert np.array_equal(got[nz], by_recip[nz])


@pytest.mark.parametrize("bits", [8, 4])
def test_ops_bitwise_equal_jax_ops(jx, bits):
    jax, jnp, _, _, jops = jx
    rng = np.random.default_rng(10 + bits)
    d = 3000
    x = (rng.standard_normal(d) * 4).astype(np.float32)
    x[512:1024] = 0.0                                    # a whole zero row
    key = jax.random.PRNGKey(bits)
    noise = np.array(jax.random.uniform(key, (ops.tile_rows(d), 512), jnp.float32))
    tx, tn = torch.from_numpy(x), torch.from_numpy(noise)
    q, s = ops.quantize_pack(tx, noise=tn, bits=bits)
    jq, js = jops.quantize_pack(jnp.asarray(x), key, bits=bits)
    assert _bits(q.numpy()) == _bits(jq) and _bits(s.numpy()) == _bits(js)
    qd = ops.quantize_dequantize(tx, noise=tn, bits=bits)
    jqd = jops.quantize_dequantize(jnp.asarray(x), key, bits=bits)
    assert _bits(qd.numpy()) == _bits(jqd)
    ud = ops.unpack_dequantize(q, s, d)
    jud = jops.unpack_dequantize(jq, js, d)
    assert _bits(ud.numpy()) == _bits(jud) == _bits(qd.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_ops_bf16_input_bitwise_equal_jax_ops(jx, bits):
    """A bf16 tensor is widened to f32 for the kernels (as the JAX kernels
    cast their tile): the bf16 carrier and the (q, scales) planes equal the
    JAX wrappers' bit for bit."""
    jax, jnp, _, _, jops = jx
    rng = np.random.default_rng(20 + bits)
    d = 3000
    x = (rng.standard_normal(d) * 4).astype(np.float32)
    x[512:1024] = 0.0                                    # a whole zero row
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jxb = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)   # the same bf16 values
    key = jax.random.PRNGKey(bits)
    noise = np.array(jax.random.uniform(key, (ops.tile_rows(d), 512), jnp.float32))
    tn = torch.from_numpy(noise)
    qd = ops.quantize_dequantize(tx, noise=tn, bits=bits)
    jqd = jops.quantize_dequantize(jxb, key, bits=bits)
    assert qd.dtype == torch.bfloat16 and jqd.dtype == jnp.bfloat16
    assert _bits(qd.view(torch.int16).numpy()) == _bits(np.asarray(jqd).view(np.int16))
    q, s = ops.quantize_pack(tx, noise=tn, bits=bits)
    jq, js = jops.quantize_pack(jxb, key, bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _bits(q.numpy()) == _bits(jq) and _bits(s.numpy()) == _bits(js)
    if bits == 8:                                        # B6 is 8-bit only
        sq, ss = ops.stream_quantize_pack(tx, tn)
        assert _bits(sq.numpy()) == _bits(jq) and _bits(ss.numpy()) == _bits(js)


def test_ops_generator_noise_is_reproducible():
    x = torch.randn(2000, generator=torch.Generator().manual_seed(0))
    a = ops.quantize_dequantize(x, generator=torch.Generator().manual_seed(5))
    b = ops.quantize_dequantize(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise= or generator="):
        ops.quantize_dequantize(x)


@pytest.mark.parametrize("n", [9, 10])
def test_nibble_pack_matches_jax_and_roundtrips(jx, n):
    _, jnp, _, _, jops = jx
    q = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    packed = ops.nibble_pack(torch.from_numpy(q))
    assert _bits(packed.numpy()) == _bits(jops.nibble_pack(jnp.asarray(q)))
    assert np.array_equal(ops.nibble_unpack(packed, n).numpy(), q)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    x, u = _tiles(rows=8)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    quant8.quant_dequant_2d(tx, tu)
    q, s = bitpack.quant_pack_2d(tx, tu)
    bitpack.unpack_dequant_2d(q, s)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, u = (torch.from_numpy(a) for a in _tiles(rows=16))
    with pytest.raises(TypeError):
        quant8.quant_dequant_2d(x.double(), u)
    with pytest.raises(ValueError):
        quant8.quant_dequant_2d(x[:12], u[:12])              # rows % 8
    with pytest.raises(ValueError):
        bitpack.quant_pack_2d(x, u[:8])                      # noise shape
    with pytest.raises(ValueError):
        bitpack.quant_pack_2d(x.t().contiguous().t(), u)     # not contiguous
    q, s = bitpack.quant_pack_2d(x, u)
    with pytest.raises(ValueError):
        bitpack.unpack_dequant_2d(q, s[:8])
    with pytest.raises(ValueError):                          # neither CPU nor CUDA
        quant8.quant_dequant_2d(x.to("meta"), u.to("meta"))


def test_nvcc_command_pins_the_numerics():
    compiles, link = build.nvcc_commands(build.BUILD_DIR / "x.so")
    assert len(compiles) == len(build.SOURCES)          # one nvcc per source
    for cmd, src in zip(compiles, build.SOURCES):
        flat = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in flat
        for flag in ("-ftz=false", "-prec-div=true", "-fmad=false", "-c"):
            assert flag in cmd
        assert "fast_math" not in flat and "use_fast_math" not in flat
        assert src.is_file() and src.parent == build.CSRC and str(src) in cmd
        assert cmd[cmd.index("-o") + 1] in link
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in " ".join(link)
    assert build.library_path().parent == build.BUILD_DIR
    text = "".join(src.read_text() for src in build.SOURCES)
    for entry in build.SIGNATURES:
        assert entry in text


def _mask(d, seed=0, p=0.3):
    return np.random.default_rng(seed).random(d) < p


@pytest.mark.parametrize("d", MASK_D)
def test_pack_bits_bitwise_equal_jax_ops(jx, d):
    """B4/B5 through ops: the stride-W word stream and its inverse."""
    _, jnp, _, _, jops = jx
    m = _mask(d, seed=d)
    jw = np.asarray(jops.pack_bits(jnp.asarray(m)))
    for mt in (torch.from_numpy(m), torch.from_numpy(m.astype(np.uint8))):
        w = ops.pack_bits(mt)
        assert w.dtype == torch.int32 and w.numpy().view(np.uint32).tobytes() == _bits(jw)
    back = ops.unpack_bits(w, d)
    assert back.dtype == torch.uint8
    assert np.array_equal(back.numpy(), np.asarray(jops.unpack_bits(jnp.asarray(jw), d)))
    assert np.array_equal(back.numpy(), m.astype(np.uint8))


@pytest.mark.parametrize("c", [128, 384])
def test_plain_mask_kernels_bitwise_equal_jax_interpret(jx, c):
    """B4/B5 on (32, C): the port's byte mask vs the Pallas kernel's uint32
    mask (equal values), words bit for bit."""
    _, jnp, _, jbp, _ = jx
    m = _mask(32 * c, seed=c, p=0.5).reshape(32, c)
    m[:, 5] = True                                   # a word with all 32 bits
    m[:, 6] = False
    jw = np.asarray(jbp.pack_mask_2d(jnp.asarray(m.astype(np.uint32))))
    w = bitpack.pack_mask_2d(torch.from_numpy(m))
    assert w.shape == (1, c) and w.numpy().view(np.uint32).tobytes() == _bits(jw)
    assert np.uint32(jw[0, 5]) == np.uint32(0xFFFFFFFF)
    jm = np.asarray(jbp.unpack_mask_2d(jnp.asarray(jw)))
    um = bitpack.unpack_mask_2d(w)
    assert um.dtype == torch.uint8 and np.array_equal(um.numpy(), jm)
    assert np.array_equal(ref.unpack_mask_ref(ref.pack_mask_ref(torch.from_numpy(m))).numpy(),
                          m.astype(np.uint8))


def test_mask_wrappers_reject_what_the_kernels_do_not_take():
    m = torch.zeros((32, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        bitpack.pack_mask_2d(m[:31])                      # not 32 rows
    with pytest.raises(TypeError):
        bitpack.pack_mask_2d(m.float())                   # not a byte mask
    with pytest.raises(ValueError):
        bitpack.pack_mask_2d(torch.zeros((8, 32), dtype=torch.bool).t())  # strided
    with pytest.raises(TypeError):
        bitpack.unpack_mask_2d(torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        bitpack.unpack_mask_2d(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.unpack_bits(torch.zeros(3, dtype=torch.int32), 200)   # 7 words needed
    with pytest.raises(ValueError):                           # neither CPU nor CUDA
        bitpack.pack_mask_2d(m.to("meta"))


def test_cpu_mask_and_stream_wrappers_count_no_launch():
    kernels.reset_launch_counts()
    ops.unpack_bits(ops.pack_bits(torch.from_numpy(_mask(100))), 100)
    x, u = _tiles(rows=16)
    stream.stream_quant_pack_2d(torch.from_numpy(x), torch.from_numpy(u))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none present)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_kernels_bitwise_equal_plain(cuda_device, bits):
    x, u = _tiles(rows=1024, seed=bits)
    tx, tu = torch.from_numpy(x).to(cuda_device), torch.from_numpy(u).to(cuda_device)
    kernels.reset_launch_counts()
    out = quant8.quant_dequant_2d(tx, tu, bits)
    q, s = bitpack.quant_pack_2d(tx, tu, bits)
    deq = bitpack.unpack_dequant_2d(q, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {name: int(name in QUANT) for name in kernels.KERNELS}
    qr, sr = ref.quant_pack_ref(tx, tu, bits)
    assert torch.equal(out.view(torch.int32), ref.quant_dequant_ref(tx, tu, bits).view(torch.int32))
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))
    assert torch.equal(deq.view(torch.int32), out.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ops_ragged_equal_cpu(cuda_device):
    """The padded, ragged ops path on the card equals the CPU's bit for bit."""
    d = 5 * 512 + 37
    x = torch.randn(d, generator=torch.Generator().manual_seed(1)) * 3
    x[1024:1536] = 0.0
    noise = torch.rand((ops.tile_rows(d), 512), generator=torch.Generator().manual_seed(2))
    cpu = ops.quantize_dequantize(x, noise=noise)
    card = ops.quantize_dequantize(x.to(cuda_device), noise=noise.to(cuda_device))
    assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", MASK_D + (5 * 512 + 37, 1 << 20))
def test_cuda_mask_kernels_bitwise_equal_plain(cuda_device, d):
    m = torch.from_numpy(_mask(d, seed=d)).to(cuda_device)
    kernels.reset_launch_counts()
    w = ops.pack_bits(m)
    back = ops.unpack_bits(w, d)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pack_mask_2d"] == 1
    assert kernels.launch_counts()["unpack_mask_2d"] == 1
    assert torch.equal(w.cpu(), ops.pack_bits(m.cpu()))
    assert torch.equal(back, m.to(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 1024, 8 * 1000 + 8])
def test_cuda_stream_kernel_equals_b2_and_plain(cuda_device, rows):
    """B6 == B2 == the plain version bit for bit, with zero rows, over more
    tiles than the persistent grid has blocks."""
    x, u = _tiles(rows=max(rows, 8), seed=rows)
    tx, tu = torch.from_numpy(x).to(cuda_device), torch.from_numpy(u).to(cuda_device)
    kernels.reset_launch_counts()
    q, s = stream.stream_quant_pack_2d(tx, tu)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stream_quant_pack_2d"] == 1
    q2, s2 = bitpack.quant_pack_2d(tx, tu)
    qr, sr = ref.stream_quant_pack_ref(tx, tu, tile_rows=64)
    assert torch.equal(q, q2) and torch.equal(s.view(torch.int32), s2.view(torch.int32))
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))
