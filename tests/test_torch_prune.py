"""Port kernels B7 (N:M prune) and B8 (fused score + mask prune) and their
ops wrappers, against the JAX package; the CUDA kernels against their plain
versions on the card.

Inputs are made from a seed with numpy and fed to both packages; the JAX
side runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
does.  Tolerances:

* 2D kernels, same inputs (w, scores, xnorm, tau and stats): masks bitwise
  equal for B7 and for B8's wanda and symwanda modes; ``out`` bitwise equal
  in bf16.  In f32 XLA's CPU compiler rewrites the interpret kernel's
  ``w * keep`` into a select, so JAX's pruned negative weights are +0.0
  where the port's product gives -0.0: f32 ``out`` is compared by value,
  and bitwise on the kept entries.
* B8 ria: ``xn ** 0.5`` is ``sqrt`` in torch but not on XLA's CPU, so masks
  agree except where the port's score lies within 4 ulp of ``tau_j``, and
  fewer than 0.1% of entries lie there.
* ``ops``: ``prune_nm`` masks bitwise equal (no statistics); ``prune_scored``
  keeps the shape, and at least 99.9% of mask entries equal the JAX ops'
  mask, every disagreement within 1e-6 * tau_j of the threshold (the input
  norms are summed in another order).

``launch.prune --ckpt`` loads a JAX-package checkpoint and a port one bit
for bit, takes replica 0 of a replica-stacked one, and raises on a missing,
extra or differently shaped leaf.

Tests marked ``cuda`` need an NVIDIA card and skip without one.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import symwanda as sw
from repro_torch.kernels import nm_prune, ops, ref, wanda_score
from repro_torch.utils.tree import tree_map

torch.set_num_threads(2)
SHAPES = [(256, 128), (384, 256)]
RAGGED = [(132, 70), (300, 129)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from repro.kernels import nm_prune as jnm
    from repro.kernels import ops as jops
    from repro.kernels import wanda_score as jws
    return jnp, jnm, jws, jops


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 pattern)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _weights(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    w[0, :5] = -0.0
    return w, torch.from_numpy(w).to(getattr(torch, dtype))


def _bits_equal(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _jw(jnp, w, dtype):
    return jnp.asarray(w).astype(getattr(jnp, dtype))


def _assert_out_equal(out, jout, mask):
    """bf16: bitwise.  f32: by value, and bitwise where kept (module doc)."""
    t, j = _np(out), _jbits(jout)
    if out.dtype == torch.bfloat16:
        assert np.array_equal(t, j)
    else:
        kept = _np(mask) != 0
        assert np.array_equal(t, j)
        assert np.array_equal(t.view(np.int32)[kept], j.view(np.int32)[kept])


def _stats(shape, seed=1):
    d_in, d_out = shape
    rng = np.random.default_rng(seed)
    xn = (np.abs(rng.standard_normal(d_in)) * np.exp(rng.standard_normal(d_in))
          + 0.01).astype(np.float32)
    yn = (np.abs(rng.standard_normal(d_out)) + 0.1).astype(np.float32)
    return xn, yn, np.float32(0.37), np.float32(1.91)


def _b8_inputs(w_t, shape, mode, seed=1):
    """Port-side keyword arguments of B8 and the JAX side's, same values."""
    xn, yn, mu_in, mu_out = _stats(shape, seed)
    kw, jkw = {}, {}
    if mode == "ria":
        aw = w_t.float().abs()
        kw = dict(rowsum=aw.sum(1), colsum=aw.sum(0))
        jkw = dict(rowsum=kw["rowsum"].numpy(), colsum=kw["colsum"].numpy())
    elif mode == "symwanda":
        kw = dict(ynorm=torch.from_numpy(yn), mu_in=float(mu_in), mu_out=float(mu_out))
        jkw = dict(ynorm=yn, rowsum=mu_in, colsum=mu_out)
    return torch.from_numpy(xn), kw, jkw


# ---------------------------------------------------------------------------
# B7 nm_prune_2d
# ---------------------------------------------------------------------------
def _nm_scores(shape, seed=2):
    s = np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    s[::7] = np.round(s[::7] * 2) / 2          # exact ties inside groups
    return s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_nm_prune_2d_bitwise_equal_jax(jx, shape, dtype):
    jnp, jnm, _, _ = jx
    w, tw = _weights(shape, dtype)
    s = _nm_scores(shape)
    out, mask = nm_prune.nm_prune_2d(tw, torch.from_numpy(s), 2, 4)
    jout, jmask = jnm.nm_prune_2d(_jw(jnp, w, dtype), jnp.asarray(s), n=2, m=4)
    assert out.dtype == mask.dtype == tw.dtype
    assert np.array_equal(_np(mask), _jbits(jmask))
    assert np.array_equal(_np(out), _jbits(jout))       # the product keeps -0.0


@pytest.mark.parametrize("n,m", [(1, 4), (3, 4), (1, 8), (2, 8), (3, 8)])
def test_nm_prune_2d_all_n_m_bitwise_equal_jax(jx, n, m):
    jnp, jnm, _, _ = jx
    w, tw = _weights((256, 128), "float32", seed=n * 10 + m)
    s = _nm_scores((256, 128), seed=m)
    out, mask = nm_prune.nm_prune_2d(tw, torch.from_numpy(s), n, m)
    jout, jmask = jnm.nm_prune_2d(jnp.asarray(w), jnp.asarray(s), n=n, m=m)
    assert np.array_equal(_np(mask), np.asarray(jmask))
    assert np.array_equal(_np(out).view(np.int32), np.asarray(jout).view(np.int32))
    assert (mask.reshape(-1, m, 128).sum(1) == n).all()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_nm_with_ties(n):
    """All-equal scores keep exactly n per group: the first n."""
    w = torch.ones((nm_prune.TILE_R, nm_prune.TILE_C))
    _, mask = nm_prune.nm_prune_2d(w, torch.ones_like(w), n=n, m=4)
    grp = mask.reshape(-1, 4, nm_prune.TILE_C)
    assert (grp.sum(1) == n).all()
    assert (grp[:, :n] == 1).all()


def test_nm_padded_minus_inf_rank_last():
    """A group whose tail is -inf (padding) keeps its finite entries first."""
    s = torch.full((128, 128), -float("inf"))
    s[0::8] = 1.0
    s[1::8] = 0.5
    _, mask = nm_prune.nm_prune_2d(torch.ones_like(s), s, n=3, m=8)
    g = mask.reshape(16, 8, 128)
    assert (g[:, 0] == 1).all() and (g[:, 1] == 1).all() and (g[:, 2] == 1).all()
    assert (g[:, 3:] == 0).all()


# ---------------------------------------------------------------------------
# B8 wanda_prune_2d
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["wanda", "symwanda"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_wanda_prune_2d_bitwise_equal_jax(jx, shape, dtype, mode):
    jnp, _, jws, _ = jx
    w, tw = _weights(shape, dtype)
    xn, kw, jkw = _b8_inputs(tw, shape, mode)
    s = ref.wanda_scores_ref(tw, xn, mode, **kw)
    tau = torch.topk(s.T, shape[0] // 2).values[:, -1].contiguous()   # s == tau occurs
    out, mask = wanda_score.wanda_prune_2d(tw, xn, tau, mode, **kw)
    jout, jmask = jws.wanda_prune_2d(_jw(jnp, w, dtype), jnp.asarray(xn.numpy()),
                                     jnp.asarray(tau.numpy()), mode=mode,
                                     **{k: jnp.asarray(v) for k, v in jkw.items()})
    assert np.array_equal(_np(mask), _jbits(jmask))
    _assert_out_equal(out, jout, mask)
    assert int(mask.float().sum(0).min()) >= shape[0] // 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_wanda_prune_2d_ria_matches_jax_off_the_threshold(jx, shape, dtype):
    jnp, _, jws, _ = jx
    w, tw = _weights(shape, dtype)
    xn, kw, jkw = _b8_inputs(tw, shape, "ria")
    s = ref.wanda_scores_ref(tw, xn, "ria", **kw)
    tau = torch.topk(s.T, shape[0] // 2).values[:, -1].contiguous()
    out, mask = wanda_score.wanda_prune_2d(tw, xn, tau, "ria", **kw)
    jout, jmask = jws.wanda_prune_2d(_jw(jnp, w, dtype), jnp.asarray(xn.numpy()),
                                     jnp.asarray(tau.numpy()), mode="ria",
                                     **{k: jnp.asarray(v) for k, v in jkw.items()})
    tau_n = tau.numpy()[None, :]
    near = np.abs(s.numpy() - tau_n) <= 4 * np.spacing(tau_n)
    differ = mask.float().numpy() != np.asarray(jmask).astype(np.float32)
    assert not (differ & ~near).any()
    near_off = near & (s.numpy() != tau_n)          # s == tau is exact on both sides
    assert near_off.mean() < 1e-3
    assert np.array_equal(_np(out)[~differ], _jbits(jout)[~differ])


def test_b8_plain_version_is_its_own_score_and_threshold():
    """keep == (score >= tau) with the module's score, and out == w * keep."""
    shape = (256, 128)
    _, tw = _weights(shape, "float32")
    for mode in ("wanda", "ria", "symwanda"):
        xn, kw, _ = _b8_inputs(tw, shape, mode)
        s = ref.wanda_scores_ref(tw, xn, mode, **kw)
        tau = s.median(0).values
        out, mask = wanda_score.wanda_prune_2d(tw, xn, tau, mode, **kw)
        assert torch.equal(mask, (s >= tau).float())
        assert torch.equal(out.view(torch.int32), (tw * mask).view(torch.int32))


def test_ria_alpha_half_is_sqrt():
    """torch.pow(x, 0.5) is sqrt bit for bit: the kernel's xn^alpha input."""
    x = torch.rand(4096, generator=torch.Generator().manual_seed(0)) * 30
    assert torch.equal(x.pow(0.5).view(torch.int32), x.sqrt().view(torch.int32))


# ---------------------------------------------------------------------------
# B8's selecting mode (tau=None): the plain version against the tau-given
# route (scored_args: full plain score matrix, torch.topk), bit for bit
# ---------------------------------------------------------------------------
def _tau_bits_equal(a, b):
    """tau bit for bit, any NaN equal to any NaN (the card's NaN is not the
    CPU's)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


def _select_vs_scored_args(W, X, mode, sparsity, run=wanda_score.wanda_prune_2d):
    """(out, mask, tau) of the selecting mode via ``run`` on scored_args'
    padded statistics, and scored_args + the tau-given plain version."""
    wp, kw, (r, c) = ops.scored_args(W, X, mode, sparsity)
    want = ref.wanda_prune_ref(wp, **kw)
    tau = kw.pop("tau")
    got = run(wp, tau=None, k=ops.keep_count(r, sparsity), rows=r, cols=c, **kw)
    return got, want + (tau,)


def _assert_select_equal(got, want, what):
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1]), what
    assert _tau_bits_equal(got[2], want[2]), what


@pytest.mark.parametrize("sparsity", [0.5, 0.6, 0.0, 1.0])    # 0.0: k = d_in, 1.0: k = 1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["wanda", "ria", "symwanda"])
@pytest.mark.parametrize("shape", [(256, 128)] + RAGGED)      # ragged: pads rows and cols
def test_b8_selecting_plain_equals_scored_args(shape, mode, dtype, sparsity):
    W, X = _layer(shape, seed=12)
    tW, tX = torch.from_numpy(W).to(dtype), torch.from_numpy(X).to(dtype)
    got, want = _select_vs_scored_args(tW, tX, mode, sparsity)
    _assert_select_equal(got, want, (shape, mode, dtype, sparsity))
    k = ops.keep_count(shape[0], sparsity)
    assert int(got[1][:shape[0], :shape[1]].float().sum(0).min()) >= k
    assert bool(torch.isinf(got[2][shape[1]:]).all())          # padded columns


def _tied_layer():
    """A (256, 128) layer whose columns 3, 5 and 7 are all zero, all equal
    and two-valued, under all-equal input norms: every score of those
    columns ties with the threshold or another score."""
    W, X = _layer((256, 128), seed=13)
    W[:, 3] = 0.0
    W[:, 5] = 0.25
    W[::2, 7], W[1::2, 7] = 0.5, -0.5
    X[:] = 1.0
    return torch.from_numpy(W), torch.from_numpy(X)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["wanda", "symwanda"])
def test_b8_selecting_plain_keeps_every_tie(mode, dtype):
    tW, tX = _tied_layer()
    tW, tX = tW.to(dtype), tX.to(dtype)
    for sparsity in (0.5, 0.7):
        got, want = _select_vs_scored_args(tW, tX, mode, sparsity)
        _assert_select_equal(got, want, (mode, sparsity))
        kept = got[1].float().sum(0)
        assert int(kept[3]) == int(kept[5]) == int(kept[7]) == 256   # ties all kept


def _nan_case():
    """ria on a weight with an all-zero column (colsum 0: 0/0 is NaN in
    every row of column 2), and wanda with three NaN input norms (NaN in
    rows 0-2 of every column)."""
    W, X = _layer((256, 128), seed=14)
    W[:, 2] = 0.0
    tW = torch.from_numpy(W)
    aw = tW.abs()
    xn = ops.input_norms(torch.from_numpy(X))
    xn_nan = xn.clone()
    xn_nan[:3] = float("nan")
    return tW, (("ria", xn, dict(rowsum=aw.sum(1), colsum=aw.sum(0))),
                ("wanda", xn_nan, {}))


@pytest.mark.parametrize("k", [1, 3, 4, 128])
def test_b8_selecting_ranks_nan_like_topk(k):
    """The choice B8 makes for NaN scores: torch.topk's order (NaN above
    everything), then s >= tau.  A column with k or more NaN scores gets a
    NaN tau and keeps nothing; otherwise tau is the k-th largest counting
    the NaNs first, and no NaN score is kept."""
    tW, cases = _nan_case()
    for mode, xn, kw in cases:
        out, mask, tau = wanda_score.wanda_prune_2d(tW, xn, None, mode, k=k, **kw)
        s = ref.wanda_scores_ref(tW, xn, mode, **kw)
        n_nan = torch.isnan(s).sum(0)
        assert torch.equal(torch.isnan(tau), n_nan >= k)
        assert not bool(mask[torch.isnan(s)].any())
        assert not bool(mask[:, n_nan >= k].any())
        fin = n_nan < k
        want = torch.where(torch.isnan(s), torch.inf, s).T.topk(k).values[:, -1]
        assert torch.equal(tau[fin], want[fin])
        assert torch.equal(mask, (s >= tau).float()) and torch.equal(out, tW * mask)


def test_b8_selecting_wrapper_rejects_what_the_kernel_does_not_take():
    w, xn, tau = torch.ones((128, 128)), torch.ones(128), torch.ones(128)
    for bad in (dict(k=None), dict(k=0), dict(k=129), dict(k=5, rows=4),
                dict(k=1, rows=129), dict(k=1, cols=129)):
        with pytest.raises(ValueError):
            wanda_score.wanda_prune_2d(w, xn, None, **bad)
    with pytest.raises(ValueError):                          # k belongs to tau=None
        wanda_score.wanda_prune_2d(w, xn, tau, k=1)


def test_ops_prune_scored_is_the_selecting_route():
    """prune_scored's result is scored_args + plain, cut to shape."""
    W, X = _layer((300, 129), seed=15)
    tW, tX = torch.from_numpy(W), torch.from_numpy(X)
    for mode in ("wanda", "ria", "symwanda"):
        out, mask = ops.prune_scored(tW, tX, mode=mode, sparsity=0.6)
        wp, kw, _ = ops.scored_args(tW, tX, mode, 0.6)
        ro, rm = ref.wanda_prune_ref(wp, **kw)
        assert _bits_equal(out, ro[:300, :129]) and _bits_equal(mask, rm[:300, :129])


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(256, 128)] + RAGGED)
def test_ops_prune_nm_matches_jax_ops(jx, shape):
    jnp, _, _, jops = jx
    w, tw = _weights(shape, "float32", seed=3)
    out, mask = ops.prune_nm(tw, tw.abs(), 2, 4)
    jout, jmask = jops.prune_nm(jnp.asarray(w), jnp.abs(jnp.asarray(w)), 2, 4)
    assert tuple(out.shape) == tuple(mask.shape) == shape
    r4 = (shape[0] // 4) * 4
    assert (mask[:r4].reshape(-1, 4, shape[1]).sum(1) == 2).all()
    assert np.array_equal(_np(mask), np.asarray(jmask))
    assert np.array_equal(_np(out), np.asarray(jout))


def _layer(shape, seed=4, dtype="float32"):
    d_in, _ = shape
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    X = (rng.standard_normal((64, d_in)) * np.exp(rng.standard_normal(d_in))).astype(np.float32)
    return W, X


@pytest.mark.parametrize("mode", ["wanda", "ria", "symwanda"])
@pytest.mark.parametrize("shape", [(256, 128)] + RAGGED)
def test_ops_prune_scored_matches_jax_ops(jx, shape, mode):
    jnp, _, _, jops = jx
    W, X = _layer(shape)
    tW, tX = torch.from_numpy(W), torch.from_numpy(X)
    out, mask = ops.prune_scored(tW, tX, mode=mode, sparsity=0.5)
    jout, jmask = jops.prune_scored(jnp.asarray(W), jnp.asarray(X), mode=mode, sparsity=0.5)
    assert tuple(out.shape) == tuple(mask.shape) == shape
    assert torch.equal(out, tW * mask)
    k = round(0.5 * shape[0])
    assert int(mask.sum(0).min()) >= k
    # where the two masks differ, the port's score sits on its threshold
    wp, kw, _ = ops.scored_args(tW, tX, mode, 0.5)
    tau = kw.pop("tau")[:shape[1]].numpy()[None, :]
    s = ref.wanda_scores_ref(wp, **kw)[:shape[0], :shape[1]].numpy()
    differ = mask.numpy() != np.asarray(jmask)
    assert differ.mean() <= 1e-3
    assert (np.abs(s - tau)[differ] <= 1e-6 * np.broadcast_to(tau, s.shape)[differ]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_symwanda_normalizers_stay_on_the_device(dtype):
    """``ops._statistics`` keeps symwanda's mu_in / mu_out as 0-d f32
    tensors (no host read); B8 on them gives, bit for bit, the masks the
    Python floats of the same values gave, in both modes."""
    W, X = _layer((300, 129), seed=16)
    tW, tX = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (W, X))
    kw = ops._statistics(tW, tX, "symwanda", 0.5, 0.5)
    for name in ("mu_in", "mu_out"):
        assert isinstance(kw[name], torch.Tensor)
        assert kw[name].shape == () and kw[name].dtype == torch.float32
    wp, pk, (r, c) = ops._padded(tW, kw)
    as_floats = dict(pk, mu_in=float(pk["mu_in"]), mu_out=float(pk["mu_out"]))
    k = ops.keep_count(r, 0.5)
    got = wanda_score.wanda_prune_2d(wp, tau=None, k=k, rows=r, cols=c, **pk)
    want = wanda_score.wanda_prune_2d(wp, tau=None, k=k, rows=r, cols=c, **as_floats)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    given = wanda_score.wanda_prune_2d(wp, tau=got[2], **pk)
    assert all(_bits_equal(g, w) for g, w in zip(given, want[:2]))


def test_ops_prune_scored_keeps_bf16():
    W, X = _layer((132, 70), seed=5)
    tW = torch.from_numpy(W).bfloat16()
    out, mask = ops.prune_scored(tW, torch.from_numpy(X).bfloat16(), mode="symwanda")
    assert out.dtype == mask.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), (tW * mask).view(torch.int16))


# ---------------------------------------------------------------------------
# module agreement inside the port (mirrors tests/test_symwanda.py:85-98)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_wanda_matches_module(dtype):
    W, X = _layer((256, 128), seed=6)
    tW = torch.from_numpy(W).to(getattr(torch, dtype))
    tX = torch.from_numpy(X).to(getattr(torch, dtype))
    for sparsity in (0.5, 0.6):
        Wp_mod, m_mod = sw.prune(tW, tX, method="wanda", sparsity=sparsity)
        Wp_k, m_k = ops.prune_scored(tW, tX, mode="wanda", sparsity=sparsity)
        assert torch.equal(m_k.float(), m_mod)
        assert torch.equal(Wp_k.float(), Wp_mod)


def test_kernel_nm_matches_module():
    W, X = _layer((256, 128), seed=7)
    tW, tX = torch.from_numpy(W), torch.from_numpy(X)
    s = sw.score_wanda(tW, tX)
    assert s.reshape(64, 4, 128).sort(1).values.diff(dim=1).ne(0).all()   # no ties
    _, m_k = ops.prune_nm(tW, s, 2, 4)
    assert torch.equal(m_k, sw.mask_nm(s, 2, 4))


def test_cpu_tensors_count_no_prune_launch():
    kernels.reset_launch_counts()
    W, X = _layer((132, 70), seed=8)
    tW, tX = torch.from_numpy(W), torch.from_numpy(X)
    ops.prune_scored(tW, tX)
    ops.prune_nm(tW, tW.abs())
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    assert wanda_score.wanda_prune_2d.selecting == 0


def test_prune_wrappers_reject_what_the_kernels_do_not_take():
    w = torch.ones((128, 128))
    s = torch.ones((128, 128))
    with pytest.raises(ValueError):
        nm_prune.nm_prune_2d(w[:100], s[:100])                     # d_in % 128
    with pytest.raises(TypeError):
        nm_prune.nm_prune_2d(w.double(), s)
    with pytest.raises(ValueError):
        nm_prune.nm_prune_2d(w, s, n=2, m=3)                       # m must divide 128
    with pytest.raises(ValueError):
        nm_prune.nm_prune_2d(w, s.t().contiguous().t()[:, :64])    # scores shape
    xn, tau = torch.ones(128), torch.ones(128)
    with pytest.raises(ValueError):
        wanda_score.wanda_prune_2d(w, xn, tau, mode="l1")
    with pytest.raises(ValueError):
        wanda_score.wanda_prune_2d(w, xn, tau, mode="ria")           # no sums
    with pytest.raises(ValueError):
        wanda_score.wanda_prune_2d(w, xn, torch.ones(256)[::2], mode="wanda")
    with pytest.raises(ValueError):                                  # neither CPU nor CUDA
        wanda_score.wanda_prune_2d(w.to("meta"), xn.to("meta"), tau.to("meta"))


# ---------------------------------------------------------------------------
# launch.prune --ckpt: pruning trained params
# ---------------------------------------------------------------------------
CKPT_ARCH = "qwen1.5-4b"


@pytest.fixture(scope="module")
def jax_params():
    """Reduced qwen1.5-4b params of the JAX package (f32, as ``reduced()``
    sets; bf16 leaves cross as in ``test_torch_train``'s checkpoint test)
    -> (the JAX tree, the same tree as the port's CPU tensors)."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params
    from repro_torch.interop import params_from_jax
    jp = init_params(jax.random.PRNGKey(5), get_config(CKPT_ARCH).reduced())
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _cfg(arch=CKPT_ARCH):
    from repro_torch.configs import get_config
    return get_config(arch).reduced()


def _assert_tree_bits_equal(got, want):
    from repro_torch.utils.tree import tree_flatten_with_path
    g, w = tree_flatten_with_path(got)[0], tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and _bits_equal(a, b), key


def _cli(path):
    from repro_torch.launch import prune as tprune
    return tprune.main(["--arch", CKPT_ARCH, "--reduced", "--device", "cpu", "--ckpt", str(path)])


def test_prune_cli_loads_a_jax_checkpoint_bit_for_bit(jax_params, tmp_path):
    from repro.training.checkpoint import save_checkpoint as jsave
    from repro_torch.launch import prune as tprune
    jp, tp = jax_params
    jsave(str(tmp_path / "jax"), jp, step=3)
    loaded = tprune.load_params(str(tmp_path / "jax"), _cfg(), "cpu")
    _assert_tree_bits_equal(loaded, tp)
    out = _cli(tmp_path / "jax")
    # the ladder prunes the loaded params, not random ones from --seed
    batch = tprune.calib_batch(_cfg(), 0, "cpu")
    assert out["dense"] == tprune.lm_loss(tp, _cfg(), batch)
    assert out["dense"] != tprune.main(["--arch", CKPT_ARCH, "--reduced", "--device", "cpu"])["dense"]
    assert all(np.isfinite(v) for v in out.values()) and len(out) == 12


def test_prune_cli_takes_replica_0_of_a_replica_checkpoint(jax_params, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.training.checkpoint import save_checkpoint as jsave
    from repro_torch.launch import prune as tprune
    jp, tp = jax_params
    stacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, a * 2 + 1]), jp)
    jsave(str(tmp_path / "hier"), stacked, step=4)
    _assert_tree_bits_equal(tprune.load_params(str(tmp_path / "hier"), _cfg(), "cpu"), tp)
    assert np.isfinite(_cli(tmp_path / "hier")["wanda@0.5"])


def test_prune_cli_loads_what_the_port_trainer_saved(tmp_path):
    from repro_torch.launch import prune as tprune
    from repro_torch.launch import train as ttrain
    for sync in ("efbv", "hier"):                  # hier: a replica axis
        path = tmp_path / sync
        state, _ = ttrain.main(["--arch", CKPT_ARCH, "--reduced", "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq", "16",
                                "--sync", sync, "--ckpt", str(path)])
        want = state.params
        if sync == "hier":
            want = tree_map(lambda a: a[0], want)
        _assert_tree_bits_equal(tprune.load_params(str(path), _cfg(), "cpu"), want)
    assert np.isfinite(_cli(tmp_path / "efbv")["magnitude@0.5"])


def test_prune_cli_raises_on_a_mismatched_checkpoint(jax_params, tmp_path):
    import jax
    from repro.configs import get_config
    from repro.models import init_params
    from repro.training.checkpoint import save_checkpoint as jsave
    from repro_torch.launch import prune as tprune
    jp, _ = jax_params
    # another architecture: no QKV biases
    jsave(str(tmp_path / "other"),
          init_params(jax.random.PRNGKey(0), get_config("h2o-danube-1.8b").reduced()))
    with pytest.raises(ValueError, match="only in the tree.*'bk'"):
        _cli(tmp_path / "other")
    # a leaf missing, and one too many
    fewer = {k: v for k, v in jp.items() if k != "final_norm"}
    jsave(str(tmp_path / "fewer"), fewer)
    with pytest.raises(ValueError, match="keys"):
        _cli(tmp_path / "fewer")
    jsave(str(tmp_path / "more"), {**jp, "extra": jp["final_norm"]})
    with pytest.raises(ValueError, match="keys"):
        _cli(tmp_path / "more")
    # one leaf of another shape
    bad = jax.tree_util.tree_map(lambda a: a, jp)
    bad["final_norm"] = {k: v[:-1] for k, v in jp["final_norm"].items()}
    jsave(str(tmp_path / "bad"), bad)
    with pytest.raises(ValueError, match="final_norm"):
        _cli(tmp_path / "bad")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none present)")
    return torch.device("cuda", 0)


def _card_check(device, W, X, dtype):
    """B8 (every mode, two sparsities) and B7 (2:4 on wanda scores) on the
    card against their plain versions on the card, bit for bit."""
    tW = W.to(device=device, dtype=dtype)
    tX = X.to(device=device, dtype=dtype)
    kernels.reset_launch_counts()
    for mode in ("wanda", "ria", "symwanda"):
        for sparsity in (0.5, 0.6):
            wp, kw, _ = ops.scored_args(tW, tX, mode, sparsity)
            out, mask = wanda_score.wanda_prune_2d(wp, **kw)
            ro, rm = ref.wanda_prune_ref(wp, **kw)
            assert _bits_equal(out, ro) and _bits_equal(mask, rm), (mode, sparsity)
    s = ops._pad2d(sw.score_wanda(tW, tX), 128, 128, -float("inf"))[0]
    wp = ops._pad2d(tW, 128, 128)[0]
    out, mask = nm_prune.nm_prune_2d(wp, s, 2, 4)
    ro, rm = ref.nm_prune_ref(wp, s, 2, 4)
    torch.cuda.synchronize()
    assert _bits_equal(out, ro) and _bits_equal(mask, rm)
    counts = kernels.launch_counts()
    assert counts["wanda_prune_2d"] == 6 and counts["nm_prune_2d"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED)
def test_cuda_prune_kernels_bitwise_equal_plain_ragged(cuda_device, shape, dtype):
    W, X = _layer(shape, seed=9)
    _card_check(cuda_device, torch.from_numpy(W), torch.from_numpy(X), dtype)


@pytest.mark.cuda
def test_cuda_prune_kernels_bitwise_equal_plain_full_width(cuda_device):
    """One h2o-danube-1.8b w_in: (2560, 6912) bf16, 512 calibration rows."""
    g = torch.Generator().manual_seed(10)
    W = torch.randn((2560, 6912), generator=g) / 2560 ** 0.5
    X = torch.randn((512, 2560), generator=g)
    _card_check(cuda_device, W, X, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_kernel_wanda_matches_module(cuda_device):
    """On the card too, the padded B8 path keeps exactly symwanda.prune's mask."""
    W, X = _layer((300, 129), seed=11)
    tW = torch.from_numpy(W).to(cuda_device)
    tX = torch.from_numpy(X).to(cuda_device)
    for sparsity in (0.5, 0.6):
        _, m_k = ops.prune_scored(tW, tX, mode="wanda", sparsity=sparsity)
        _, m_mod = sw.prune(tW, tX, method="wanda", sparsity=sparsity)
        assert torch.equal(m_k, m_mod)


def _card_select_check(device, tW, tX, sparsities=(0.5, 0.6)):
    """Selecting B8 on the card, every mode: (out, mask, tau) bit for bit
    equal to scored_args + the tau-given plain version on the card (tau is
    torch.topk's), and the tau-given kernel equal to its plain version."""
    for mode in ("wanda", "ria", "symwanda"):
        for sparsity in sparsities:
            kernels.reset_launch_counts()
            got, want = _select_vs_scored_args(tW.to(device), tX.to(device), mode, sparsity)
            assert wanda_score.wanda_prune_2d.selecting == 1
            torch.cuda.synchronize()
            _assert_select_equal(got, want, (mode, sparsity))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 128)] + RAGGED)
def test_cuda_b8_selecting_bitwise_equal_topk_ragged(cuda_device, shape, dtype):
    W, X = _layer(shape, seed=16)
    _card_select_check(cuda_device, torch.from_numpy(W).to(dtype),
                       torch.from_numpy(X).to(dtype), (0.5, 0.6, 0.0, 1.0))


@pytest.mark.cuda
def test_cuda_b8_selecting_bitwise_equal_topk_full_width(cuda_device):
    """One h2o-danube-1.8b w_in: (2560, 6912) bf16, 512 calibration rows."""
    g = torch.Generator().manual_seed(17)
    W = torch.randn((2560, 6912), generator=g) / 2560 ** 0.5
    X = torch.randn((512, 2560), generator=g)
    _card_select_check(cuda_device, W.bfloat16(), X.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_b8_selecting_tied_zero_and_equal_columns(cuda_device, dtype):
    tW, tX = _tied_layer()
    _card_select_check(cuda_device, tW.to(dtype), tX.to(dtype), (0.5, 0.7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_b8_selecting_too_tall_for_shared_memory(cuda_device, dtype):
    """d_in = 7040 rows of f32 keys (220 KB a strip, beside the 8 KB gather
    buffers) exceed the 227 KB a block can hold: the search recomputes each
    key from w in global memory."""
    W, X = _layer((7040 - 37, 200), seed=18)
    _card_select_check(cuda_device, torch.from_numpy(W).to(dtype),
                       torch.from_numpy(X).to(dtype), (0.5,))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4, 128])
def test_cuda_b8_selecting_ranks_nan_like_topk(cuda_device, k):
    tW, cases = _nan_case()
    for mode, xn, kw in cases:
        kw = {n: v.to(cuda_device) for n, v in kw.items()}
        got = wanda_score.wanda_prune_2d(tW.to(cuda_device), xn.to(cuda_device), None,
                                         mode, k=k, **kw)
        want = ref.wanda_prune_ref(tW.to(cuda_device), xn.to(cuda_device), None, mode,
                                   k=k, **kw)
        torch.cuda.synchronize()
        _assert_select_equal(got, want, (mode, k))
