"""Port compressors, codecs, buckets and ledger against the JAX package.

Tolerance: none — compressor carriers, wire planes, ``Payload.nbytes``,
bucket layouts and ledger tags must be identical.  Stochastic compressors get
the JAX package's own draws injected (``noise=``).  Payloads cross-decode in
both directions.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm import buckets, codecs, ledger
from repro_torch.core import compressors as tc
from repro_torch.kernels.ops import tile_rows
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

D = 3000


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.comm import buckets as jbuckets
    from repro.comm import codecs as jcodecs
    from repro.comm import ledger as jledger
    from repro.core import compressors as jc
    return jax, jnp, jc, jcodecs, jbuckets, jledger


def _x(seed=0, d=D):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(d) * rng.uniform(0.1, 5.0)).astype(np.float32)
    x[600:1200] = 0.0
    return x


def _jax_noise(jx, name, key, d):
    """The uniform draws the JAX compressor makes inside ``c(key, x)``."""
    jax, jnp = jx[0], jx[1]
    if name.startswith("qsgd_kernel"):
        return np.array(jax.random.uniform(key, (tile_rows(d), 512), jnp.float32))
    if name.startswith("qsgd"):
        nb = -(-d // 2048)
        return np.array(jax.random.uniform(key, (nb, 2048), minval=-0.5, maxval=0.5))
    return None


CASES = [("identity", {}), ("top_k", {"k_frac": 0.05}), ("qsgd", {"bits": 8}),
         ("qsgd", {"bits": 4}), ("qsgd_kernel", {"bits": 8}),
         ("qsgd_kernel", {"bits": 4}), ("topk_block", {"k_frac": 0.05, "block": 256}),
         ("topk_block", {"k_frac": 0.01})]


def _pair(jx, name, kw, seed):
    jc = jx[2]
    key = jx[0].random.PRNGKey(seed)
    x = _x(seed)
    noise = _jax_noise(jx, name, key, x.size)
    return (jc.make_compressor(name, **kw), tc.make_compressor(name, **kw), key, x,
            None if noise is None else torch.from_numpy(noise))


@pytest.mark.parametrize("name,kw", CASES)
def test_carrier_equals_jax(jx, name, kw):
    jcomp, tcomp, key, x, noise = _pair(jx, name, kw, seed=1)
    want = np.asarray(jcomp(key, jx[1].asarray(x)))
    got = tcomp(torch.from_numpy(x), noise=noise).numpy()
    assert got.tobytes() == want.tobytes()
    assert (tcomp.eta, tcomp.omega, tcomp.bits_per_dim, tcomp.wire) == \
        (jcomp.eta, jcomp.omega, jcomp.bits_per_dim, tc.WireSpec(**vars(jcomp.wire)))


@pytest.mark.parametrize("name,kw", CASES)
def test_payload_planes_equal_and_cross_decode(jx, name, kw):
    jcodecs = jx[3]
    jcomp, tcomp, key, x, noise = _pair(jx, name, kw, seed=2)
    jp = jcodecs.encode(jcomp, key, jx[1].asarray(x))
    tp = codecs.encode(tcomp, torch.from_numpy(x), noise=noise)
    assert (tp.scheme, tp.shape, tp.dtype) == (jp.scheme, jp.shape, jp.dtype)
    assert tp.nbytes == jp.nbytes
    assert sorted(tp.planes) == sorted(jp.planes)
    for k in jp.planes:
        assert tp.planes[k].dtype == np.asarray(jp.planes[k]).dtype, k
        assert tp.planes[k].tobytes() == np.asarray(jp.planes[k]).tobytes(), k
    assert tp.meta == jp.meta
    want = np.asarray(jcodecs.decode(jp))
    assert codecs.decode(jp, device="cpu").numpy().tobytes() == want.tobytes()
    assert np.asarray(jcodecs.decode(tp)).tobytes() == want.tobytes()
    # decode(encode(x)) == carrier, elementwise
    carrier = tcomp(torch.from_numpy(x), noise=noise)
    assert bool((codecs.decode(tp, device="cpu") == carrier).all())


@pytest.mark.parametrize("shape", [(4, 512), (3, 100)])
def test_quant_last_axis_planes_equal(jx, shape):
    """axis="last": blocked along the last dim, or one scale when it does
    not block evenly (qsgd_sharded's carrier, fed to both codecs)."""
    jax, jnp, jc, jcodecs = jx[:4]
    jcomp = jc.make_compressor("qsgd_sharded", bits=8, block=256)
    key = jax.random.PRNGKey(4)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    y = np.array(jcomp(key, jnp.asarray(x)))
    fixed = tc.Compressor("fixed", lambda xx, noise, gen: torch.from_numpy(y),
                          eta=0.0, omega=0.0, bits_per_dim=8.0, flatten=False,
                          wire=tc.WireSpec("quant", block=256, bits=8, axis="last"))
    jp = jcodecs.encode(jcomp, key, jnp.asarray(x))
    tp = codecs.encode(fixed, torch.from_numpy(x))
    assert tp.meta == jp.meta and tp.nbytes == jp.nbytes
    for k in jp.planes:
        assert tp.planes[k].tobytes() == np.asarray(jp.planes[k]).tobytes()
    assert codecs.decode(tp, device="cpu").numpy().tobytes() == y.tobytes()


def test_scale_compressor_gain_rides_in_the_payload(jx):
    jax, jnp, jc, jcodecs = jx[:4]
    x = _x(5)
    jcomp = jc.scale_compressor(jc.make_compressor("qsgd", bits=8), 0.5)
    tcomp = tc.scale_compressor(tc.make_compressor("qsgd", bits=8), 0.5)
    key = jax.random.PRNGKey(5)
    noise = torch.from_numpy(_jax_noise(jx, "qsgd", key, x.size))
    jp = jcodecs.encode(jcomp, key, jnp.asarray(x))
    tp = codecs.encode(tcomp, torch.from_numpy(x), noise=noise)
    assert tp.meta == jp.meta
    assert tp.planes["q"].tobytes() == np.asarray(jp.planes["q"]).tobytes()
    assert codecs.decode(tp, device="cpu").numpy().tobytes() == \
        np.asarray(jcodecs.decode(jp)).tobytes()


def test_validation_and_checksums_name_the_bad_plane():
    tcomp = tc.make_compressor("qsgd_kernel", bits=8)
    x = torch.from_numpy(_x(6))
    p = codecs.encode(tcomp, x, generator=torch.Generator().manual_seed(0))
    bad = codecs.Payload(p.scheme, p.shape, p.dtype,
                         {"q": p.planes["q"][:-3], "scales": p.planes["scales"]}, dict(p.meta))
    with pytest.raises(codecs.PayloadError) as e:
        codecs.decode(bad, device="cpu")
    assert e.value.plane == "q"
    codecs.seal_payload(p)
    codecs.verify_payload(p)
    p.planes["scales"] = p.planes["scales"].copy()
    p.planes["scales"][0] += 1.0
    with pytest.raises(codecs.PayloadError) as e:
        codecs.decode(p, device="cpu")
    assert e.value.plane == "scales"


def test_bucket_layout_and_values_equal_jax(jx):
    jax = jx[0]
    jbuckets = jx[4]
    from repro.configs import get_config
    from repro.models import init_params
    from repro_torch.interop import params_from_jax

    cfg = get_config("h2o-danube-1.8b").reduced()
    jp = init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jb, jl = jbuckets.bucketize(jp, 4096)
    tb, tl = buckets.bucketize(tp, 4096)
    assert (tl.shapes, tl.dtypes, tl.sizes, tl.offsets, tl.d, tl.n_buckets) == \
        (jl.shapes, jl.dtypes, jl.sizes, jl.offsets, jl.d, jl.n_buckets)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    back = buckets.debucketize(tb, tl)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    stacked = {"a": torch.stack([tb[0], tb[1]]), "b": torch.ones(2, 3, 5)}
    jstacked = {"a": np.stack([np.asarray(jb)[0], np.asarray(jb)[1]]), "b": np.ones((2, 3, 5), np.float32)}
    gb, gl = buckets.bucketize_groups(stacked, 1024)
    jgb, jgl = jbuckets.bucketize_groups(jstacked, 1024)
    assert gl.offsets == jgl.offsets and gb.numpy().tobytes() == np.asarray(jgb).tobytes()
    back_g = buckets.debucketize_groups(gb, gl)
    assert torch.equal(back_g["a"], stacked["a"]) and torch.equal(back_g["b"], stacked["b"])


def test_tree_walkers_leave_no_reference_cycles():
    """Flatten/unflatten/bucketize must free their leaves by reference
    counting alone: a cycle would keep a full-width model's tensors alive
    until the cyclic collector ran (it once held a 7 GB block per step)."""
    import gc
    import weakref

    from repro_torch.utils.tree import tree_flatten_with_path, tree_map, tree_unflatten

    gc.disable()
    try:
        leaf = torch.ones(8, 4)
        ref = weakref.ref(leaf)
        tree = {"b": [leaf, (torch.zeros(3),)], "a": {"x": torch.ones(2)}}
        leaves, td = tree_flatten_with_path(tree)
        back = tree_unflatten(td, [v for _, v in leaves])
        doubled = tree_map(lambda t: t * 2, back)
        blocks, layout = buckets.bucketize(doubled, 16)
        again = buckets.debucketize(blocks, layout)
        del leaf, tree, leaves, back, doubled, blocks, again
        assert ref() is None
    finally:
        gc.enable()


def test_codec_spans_are_recorded_only_when_tracing_is_on():
    from repro_torch.obs import trace

    comp = tc.make_compressor("top_k", k_frac=0.1)
    x = torch.from_numpy(_x(7))
    tracer = trace.get_tracer()
    tracer.reset()
    assert trace.span("codec/encode") is trace.NULL_SPAN or trace.enabled()
    was = trace.enabled()
    trace.enable()
    try:
        p = codecs.encode(comp, x)
        codecs.decode(p, device="cpu")
    finally:
        if not was:
            trace.disable()
    names = [s.name for s in tracer.spans()]
    assert names == ["codec/encode", "codec/decode"]
    assert tracer.spans()[0].tags == {"scheme": "sparse_idx32", "nbytes": p.nbytes}
    if not was:
        tracer.reset()
        codecs.encode(comp, x)
        assert tracer.n_recorded == 0


def test_ledger_tags_and_totals_match_jax(jx):
    jledger = jx[5]
    static = {jledger.RETRY_TAG, jledger.UPLOAD_TAG, jledger.BROADCAST_TAG,
              jledger.PAGE_IN_TAG, jledger.PAGE_OUT_TAG} | jledger.WIRE_SCHEME_TAGS
    assert static <= ledger.known_tags()
    assert (ledger.PAGE_IN_TAG, ledger.PAGE_OUT_TAG) == (jledger.PAGE_IN_TAG, jledger.PAGE_OUT_TAG)
    t, j = ledger.CommLedger(), jledger.CommLedger()
    for led in (t, j):
        led.record(0, "a->b", 10, tag=ledger.PAGE_IN_TAG)
        led.record(1, "a->c", 7, kind="intra", tag=ledger.PAGE_OUT_TAG)
    assert (t.total_bytes, t.bytes_by_tag(), t.bytes_by_round(), t.bytes_by_kind(),
            t.summary()) == (j.total_bytes, j.bytes_by_tag(), j.bytes_by_round(),
                             j.bytes_by_kind(), j.summary())


@pytest.mark.parametrize("name,kw", [("top_k", {"k_frac": 0.05}), ("identity", {}),
                                     ("topk_block", {"k_frac": 0.05, "block": 256})])
def test_bitmap_override_planes_equal_and_cross_decode(jx, name, kw):
    """encode(..., scheme="sparse_bitmap"): any sparsifier's carrier as a
    presence bitmap (B4) + values; decoded through B5's plain version."""
    jcodecs = jx[3]
    jcomp, tcomp, key, x, _ = _pair(jx, name, kw, seed=8)
    jp = jcodecs.encode(jcomp, key, jx[1].asarray(x), scheme="sparse_bitmap")
    tp = codecs.encode(tcomp, torch.from_numpy(x), scheme="sparse_bitmap")
    assert (tp.scheme, tp.shape, tp.dtype, tp.meta) == (jp.scheme, jp.shape, jp.dtype, jp.meta)
    assert tp.nbytes == jp.nbytes == 4 * -(-x.size // 32) + 4 * tp.planes["values"].size
    for k in jp.planes:
        assert tp.planes[k].dtype == np.asarray(jp.planes[k]).dtype, k
        assert tp.planes[k].tobytes() == np.asarray(jp.planes[k]).tobytes(), k
    want = np.asarray(jcodecs.decode(jp))
    assert codecs.decode(jp, device="cpu").numpy().tobytes() == want.tobytes()
    assert np.asarray(jcodecs.decode(tp)).tobytes() == want.tobytes()
    assert bool((codecs.decode(tp, device="cpu") == tcomp(torch.from_numpy(x))).all())


@pytest.mark.parametrize("nbits", [1, 3, 8, 11, 13, 32, 56])
def test_uint_stream_bytes_equal_jax(jx, nbits):
    jcodecs = jx[3]
    rng = np.random.default_rng(nbits)
    vals = rng.integers(0, 2 ** min(nbits, 62), 997, dtype=np.int64) & ((1 << nbits) - 1)
    want = jcodecs._pack_uint_stream(vals.astype(np.uint64), nbits)
    got = codecs._pack_uint_stream(torch.from_numpy(vals), nbits)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    back = codecs._unpack_uint_stream(got, vals.size, nbits, "cpu")
    assert np.array_equal(back.numpy(), vals)
    assert np.array_equal(back.numpy(), jcodecs._unpack_uint_stream(want, vals.size, nbits))


def _bitmap_and_block_payloads():
    x = torch.from_numpy(_x(9))
    bm = codecs.encode(tc.make_compressor("top_k", k_frac=0.05), x, scheme="sparse_bitmap")
    blk = codecs.encode(tc.make_compressor("topk_block", k_frac=0.05, block=256), x)
    return bm, blk


@pytest.mark.parametrize("which,plane,cut", [
    ("bitmap", "mask_words", lambda a: a[:-1]), ("bitmap", "values", lambda a: a[:-1]),
    ("block", "local_indices", lambda a: a[:-1]), ("block", "values", lambda a: a[:-2]),
    ("block", "block_counts", lambda a: a[:-1])])
def test_validation_names_the_bad_sparse_plane(which, plane, cut):
    bm, blk = _bitmap_and_block_payloads()
    p = bm if which == "bitmap" else blk
    planes = dict(p.planes)
    planes[plane] = cut(planes[plane])
    with pytest.raises(codecs.PayloadError) as e:
        codecs.decode(codecs.Payload(p.scheme, p.shape, p.dtype, planes, dict(p.meta)),
                      device="cpu")
    assert e.value.plane == plane


def test_validation_catches_a_flipped_mask_bit_and_an_overfull_block():
    bm, blk = _bitmap_and_block_payloads()
    words = bm.planes["mask_words"].copy()
    words[0] ^= np.uint32(1 << 7)                 # one bit more or fewer
    with pytest.raises(codecs.PayloadError) as e:
        codecs.validate_payload(codecs.Payload(bm.scheme, bm.shape, bm.dtype,
                                               {**bm.planes, "mask_words": words}, bm.meta))
    assert e.value.plane == "values"
    counts = blk.planes["block_counts"].copy()
    counts[0] = 257
    with pytest.raises(codecs.PayloadError) as e:
        codecs.validate_payload(codecs.Payload(blk.scheme, blk.shape, blk.dtype,
                                               {**blk.planes, "block_counts": counts},
                                               blk.meta))
    assert e.value.plane == "block_counts"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitmap_validation_counts_every_set_bit(seed):
    """validate_payload's popcount equals np.unpackbits' count, high bits and
    all-ones words included."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=37, dtype=np.uint32)
    words[0], words[1] = 0xFFFFFFFF, 0x80000000
    pop = int(np.unpackbits(words.view(np.uint8)).sum())
    d = 32 * words.size

    def payload(n_values):
        return codecs.Payload("sparse_bitmap", (d,), "float32",
                              {"mask_words": words,
                               "values": np.zeros(n_values, np.float32)}, {"d": d})

    codecs.validate_payload(payload(pop))
    with pytest.raises(codecs.PayloadError) as e:
        codecs.validate_payload(payload(pop + 1))
    assert e.value.plane == "values"


@pytest.mark.parametrize("name,kw,scheme", [
    ("identity", {}, None), ("top_k", {"k_frac": 0.05}, None),
    ("top_k", {"k_frac": 0.05}, "sparse_bitmap"), ("topk_block", {"k_frac": 0.05}, None),
    ("qsgd", {"bits": 8}, None), ("qsgd", {"bits": 4}, None),
    ("qsgd_kernel", {"bits": 8}, None), ("qsgd_kernel", {"bits": 4}, None)])
def test_size_model_equals_jax(jx, name, kw, scheme):
    """encoded_bits, extrapolate_bits (to several d) and analytic_bits."""
    jcodecs = jx[3]
    jcomp, tcomp, key, x, noise = _pair(jx, name, kw, seed=10)
    jbits = jcodecs.encoded_bits(jcomp, key, jx[1].asarray(x), scheme=scheme)
    assert codecs.encoded_bits(tcomp, torch.from_numpy(x), noise=noise, scheme=scheme) == jbits
    jp = jcodecs.encode(jcomp, key, jx[1].asarray(x), scheme=scheme)
    tp = codecs.encode(tcomp, torch.from_numpy(x), noise=noise, scheme=scheme)
    assert tp.nbits == jp.nbits == jbits
    for d in (x.size, 4 * x.size + 7, 1_831_202_816):
        assert codecs.extrapolate_bits(tp, x.size, d) == jcodecs.extrapolate_bits(jp, x.size, d)
        assert codecs.analytic_bits(tcomp, d) == jcodecs.analytic_bits(jcomp, d)


@pytest.mark.parametrize("name,kw", CASES)
def test_roundtrip_equal_matches_jax(jx, name, kw):
    jcodecs = jx[3]
    jcomp, tcomp, key, x, noise = _pair(jx, name, kw, seed=11)
    assert jcodecs.roundtrip_equal(jcomp, key, jx[1].asarray(x))
    assert codecs.roundtrip_equal(tcomp, torch.from_numpy(x), noise=noise)
    assert codecs.roundtrip_equal(tcomp, torch.from_numpy(x), seed=3)
