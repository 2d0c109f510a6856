"""The port's compressors and synchronization against the JAX package.

Tolerance: none.  Over 3 rounds (4 for the depth-3 cascade) the sync's
returns (``g_est`` or the replicas) and its state (``h``, ``h_bar``, the
anchors, ``step``) must equal the JAX package's bit for bit, with the JAX
package's own draws rebuilt from its keys and injected (``noise=``):
``split(key, G)`` on the fused path, ``fold_in(key, li)`` then ``split`` per
leaf, and ``_level_key`` (by distance from the root) in the cascade.  Every
leaf draws from its own key: one key reused across leaves once produced
tied values (ROADMAP Queue 3).  The scalings (lambda, nu) must be equal as
floats.

The JAX functions run op by op, each operation rounding as the source
writes it: ``efbv_sync`` eagerly (every jnp operation compiles alone), the
replica syncs under ``jax.disable_jit()`` (their ``lax.cond``/``lax.switch``
would compile a branch into one fused computation), with only the key and
uniform draws compiled whole (``eager``).  Fused, XLA's CPU
backend contracts ``h + lam * d`` into one multiply-add
(``test_xla_jit_contracts``), which moves the last bit wherever lam is not
a power of two; the port keeps the reference's two operations, as the GPU
path must.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import LevelConfig as TLevel
from repro_torch.configs.base import SyncConfig as TSync
from repro_torch.core import compressors as tc
from repro_torch.core import distributed as tdist
from repro_torch.kernels.ops import tile_rows
from repro_torch.utils.tree import tree_flatten, tree_map

torch.set_num_threads(2)

# one leaf that qsgd_sharded's 256-blocks do not divide; one shape set for
# every test, so the op-by-op JAX references reuse their compiled ops
SHAPES = {"a": (6, 10), "c": {"w": (2, 3, 256)}, "n": (512,)}
BUCKET = 4096
G = 2


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.core import compressors as jc
    from repro.core import distributed as jdist
    return jax, jnp, jc, jdist, jbase


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _rand_tree(shapes, seed, lead=()):
    rng = np.random.default_rng(seed)
    return _tree(shapes, lambda s: (rng.standard_normal(lead + s) *
                                    rng.uniform(0.1, 3.0)).astype(np.float32))


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_bits(jtree, ttree, what):
    jl, tl = tree_flatten(jtree)[0], tree_flatten(ttree)[0]
    assert len(jl) == len(tl), what
    for i, (a, b) in enumerate(zip(jl, tl)):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (what, i, float(np.abs(a - b).max()))


def jax_draw(jx, name, key, shape):
    """The uniform draws the JAX sync compressor ``name`` makes inside
    ``c(key, x)`` for an input of ``shape`` (None: deterministic)."""
    jax, jnp = jx[0], jx[1]
    d = int(np.prod(shape))
    if name == "qsgd_kernel":
        return torch.from_numpy(np.array(jax.random.uniform(key, (tile_rows(d), 512), jnp.float32)))
    if name in ("rand_k", "comp_k"):
        return torch.from_numpy(np.array(jax.random.uniform(key, (d,))))
    if name == "qsgd":                      # qsgd_sharded, block 256
        last = shape[-1] if len(shape) else 1
        y = tuple(shape[:-1]) + (last // 256, 256) if len(shape) and last % 256 == 0 else shape
        return torch.from_numpy(np.array(jax.random.uniform(key, y)))
    if name == "mix_k":
        k1, _, k3 = jax.random.split(key, 3)
        return (torch.from_numpy(np.array(jax.random.uniform(k1))),
                torch.from_numpy(np.array(jax.random.uniform(k3, (d,)))))
    return None


def eager(jax, fn):
    """``fn`` run op by op under ``jax.disable_jit()``: every arithmetic
    operation compiles and rounds alone (no contracted multiply-add, no
    ``lax.cond``/``lax.switch`` branch compiled into one computation).  The
    key and uniform draws (``jax.random.split``/``fold_in``/``uniform``:
    integer hashing and a bit cast, the same bits either way) compile whole,
    once per shape, instead of op by op."""
    rnd = jax.random
    saved = {name: getattr(rnd, name) for name in ("split", "fold_in", "uniform")}

    def jitted(f):
        def call(*args, **kw):
            with jax.disable_jit(False):
                return f(*args, **kw)
        return call

    def run(*args):
        for name, f in saved.items():
            setattr(rnd, name, jitted(f))
        try:
            with jax.disable_jit():
                return fn(*args)
        finally:
            for name, f in saved.items():
                setattr(rnd, name, f)
    return run


def _leaf_shapes(shapes):
    return [a.shape for a in tree_flatten(_tree(shapes, lambda s: np.zeros(s)))[0]]


def _d(shapes):
    return sum(int(np.prod(s)) for s in _leaf_shapes(shapes))


_DRAWN = ("qsgd_kernel", "rand_k", "comp_k", "qsgd")
_DRAW_FNS = {}


def _keyed_draws(jx, name, keys, shape):
    """``jax_draw`` for each key, drawn in one jitted, vmapped call (row i is
    key i's; the draws are integer hashing and a bit cast, so jitted they
    equal the op-by-op ones bit for bit).  Compiled once per name and shape
    and shared by every test of the module."""
    if name not in _DRAWN:
        return None
    jax = jx[0]
    fn = _DRAW_FNS.get((name, tuple(shape)))
    if fn is None:
        fn = _DRAW_FNS[(name, tuple(shape))] = jax.jit(
            jax.vmap(lambda k: jnp_draw(jx, name, k, tuple(shape))))
    return torch.from_numpy(np.array(fn(keys)))


def jnp_draw(jx, name, key, shape):
    d = int(np.prod(shape))
    jax, jnp = jx[0], jx[1]
    if name == "qsgd_kernel":
        return jax.random.uniform(key, (tile_rows(d), 512), jnp.float32)
    if name in ("rand_k", "comp_k"):
        return jax.random.uniform(key, (d,))
    last = shape[-1]
    y = tuple(shape[:-1]) + (last // 256, 256) if last % 256 == 0 else shape
    return jax.random.uniform(key, y)


def fused_draws(jx, name, key, n, d):
    return _keyed_draws(jx, name, jx[0].random.split(key, n), (d,))


def leaf_draws(jx, name, key, n, shapes):
    jax = jx[0]
    return [_keyed_draws(jx, name, jax.random.split(jax.random.fold_in(key, li), n), s)
            for li, s in enumerate(_leaf_shapes(shapes))]


# ---------------------------------------------------------------------------
# compressors and calculus
# ---------------------------------------------------------------------------
CARRIERS = [("rand_k", {"k_frac": 0.1}, (1000,)), ("comp_k", {"k_frac_top": 0.05, "k_frac_rand": 0.3}, (1000,)),
            ("qsgd_sharded", {}, (4, 512)), ("qsgd_sharded", {}, (3, 100)),
            ("qsgd_sharded", {"bits": 4, "block": 128}, (2, 3, 256))]


@pytest.mark.parametrize("name,kw,shape", CARRIERS)
def test_new_compressor_carriers_equal_jax(jx, name, kw, shape):
    jax, jnp, jc = jx[:3]
    jcomp, tcomp = jc.make_compressor(name, **kw), tc.make_compressor(name, **kw)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    x[0] = 0.0
    key = jax.random.PRNGKey(9)
    want = np.asarray(jcomp(key, jnp.asarray(x)))
    dname = "qsgd" if name == "qsgd_sharded" else name
    if name == "qsgd_sharded":
        blk = kw.get("block", 256)
        y = shape[:-1] + (shape[-1] // blk, blk) if shape[-1] % blk == 0 else shape
        noise = torch.from_numpy(np.array(jax.random.uniform(key, y)))
    else:
        noise = jax_draw(jx, dname, key, shape)
    got = tcomp(torch.from_numpy(x), noise=noise).numpy()
    assert got.tobytes() == want.tobytes()
    assert (tcomp.eta, tcomp.omega, tcomp.bits_per_dim, tcomp.flatten, tcomp.wire) == \
        (jcomp.eta, jcomp.omega, jcomp.bits_per_dim, jcomp.flatten, tc.WireSpec(**vars(jcomp.wire)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mix_k_takes_both_branches_as_jax(jx, seed):
    jax, jnp, jc = jx[:3]
    jcomp, tcomp = jc.mix_k(0.05, 0.2, rho=0.5), tc.mix_k(0.05, 0.2, rho=0.5)
    x = np.random.default_rng(seed).standard_normal(800).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jcomp(key, jnp.asarray(x)))
    got = tcomp(torch.from_numpy(x), noise=jax_draw(jx, "mix_k", key, (800,))).numpy()
    assert got.tobytes() == want.tobytes()


def test_calculus_and_sync_params_equal_jax(jx):
    jc, jdist, jbase = jx[2], jx[3], jx[4]
    for eta, omega in [(0.0, 0.0), (0.3, 0.5), (0.9, 2.0), (0.5, 0.0)]:
        assert tc.lambda_star(eta, omega) == jc.lambda_star(eta, omega)
        assert tc.nu_star(eta, omega / 4) == jc.nu_star(eta, omega / 4)
        assert tc.efbv_rates(eta, 0.5, 0.1, 0.7, 0.9) == jc.efbv_rates(eta, 0.5, 0.1, 0.7, 0.9)
        assert tc.efbv_stepsize(1.0, 2.0, eta, 0.5, 0.1, 0.7, 0.9) == \
            jc.efbv_stepsize(1.0, 2.0, eta, 0.5, 0.1, 0.7, 0.9)
    for mode in ("dense", "efbv", "ef21", "diana", "hier", "local"):
        for comp in ("identity", "top_k", "topk_block", "rand_k", "qsgd", "qsgd_kernel"):
            for n in (1, 2, 5):
                kw = dict(mode=mode, compressor=comp, compress_ratio=0.1)
                assert tdist.sync_params(TSync(**kw), n) == jdist.sync_params(jbase.SyncConfig(**kw), n)
    a = tc.top_k(0.25).contractive_alpha()
    assert a == jc.top_k(0.25).contractive_alpha()


def test_estimate_eta_omega_and_tree_compress():
    gen = torch.Generator().manual_seed(0)
    eta, omega = tc.estimate_eta_omega(tc.rand_k(0.25), gen, dim=64, n_vectors=4, n_samples=256)
    assert eta < 0.5 and abs(omega - 3.0) < 1.5          # unbiased, omega = d/k - 1
    eta, omega = tc.estimate_eta_omega(tc.top_k(0.25), gen, dim=64, n_vectors=4, n_samples=2)
    assert omega == 0.0 and eta < math.sqrt(0.75) + 1e-6
    tree = {"b": torch.arange(8.0), "a": torch.ones(4)}
    noise = [torch.full((4,), 0.1), torch.linspace(0, 0.9, 8)]   # leaf order a, b
    out = tc.tree_compress(tc.rand_k(0.5), tree, noise=noise)
    assert torch.equal(out["a"], torch.full((4,), 2.0))
    assert torch.equal(out["b"], torch.tensor([0, 2, 4, 6, 0, 0, 0, 0.0]))


# ---------------------------------------------------------------------------
# efbv_sync (fused and per-leaf; efbv, ef21, diana)
# ---------------------------------------------------------------------------
EFBV_CASES = ([("efbv", c, BUCKET) for c in ("identity", "top_k", "topk_block", "rand_k",
                                             "qsgd", "qsgd_kernel")]
              + [("efbv", c, 0) for c in ("top_k", "rand_k", "qsgd_kernel")]
              + [(m, c, BUCKET) for m in ("ef21", "diana") for c in ("topk_block", "qsgd_kernel")])


@pytest.mark.parametrize("mode,comp,bucket", EFBV_CASES)
def test_efbv_sync_bitwise_over_rounds(jx, mode, comp, bucket):
    jax, jnp, _, jdist, jbase = jx
    kw = dict(mode=mode, compressor=comp, compress_ratio=0.1, bucket_size=bucket)
    jsync, tsync = jbase.SyncConfig(**kw), TSync(**kw)
    jcomp, tcomp = jdist.build_compressor(jsync), tdist.build_compressor(tsync)
    lam, nu = jdist.sync_params(jsync, G)
    assert tdist.sync_params(tsync, G) == (lam, nu)
    params = _rand_tree(SHAPES, 0)
    jstate = jdist.sync_state_init(jax.tree_util.tree_map(jnp.asarray, params), G, jsync)
    tstate = tdist.sync_state_init(_to_torch(params), G, tsync)
    fused = bool(bucket) and tcomp.flatten
    assert (tstate.layout is not None) == fused
    def jfn(k, g, s):
        return jdist.efbv_sync(k, g, s, jcomp, lam, nu, bucket_size=bucket)
    for r in range(3):
        grads = _rand_tree(SHAPES, 10 + r, lead=(G,))
        key = jax.random.PRNGKey(100 + r)
        noise = (fused_draws(jx, comp, key, G, _d(SHAPES)) if fused
                 else leaf_draws(jx, comp, key, G, SHAPES))
        jg, jstate = jfn(key, jax.tree_util.tree_map(jnp.asarray, grads), jstate)
        tg, tstate = tdist.efbv_sync(_to_torch(grads), tstate, tcomp, lam, nu,
                                     bucket_size=bucket, noise=noise)
        _assert_bits(jg, tg, f"g_est round {r}")
        h, h_bar = tdist.sync_state_trees(tstate)
        _assert_bits(jstate.h, h, f"h round {r}")
        _assert_bits(jstate.h_bar, h_bar, f"h_bar round {r}")
        assert tstate.step == int(jstate.step) == r + 1


def test_b1_chunks_equal_the_whole_call(jx, monkeypatch):
    """The fused qsgd_kernel sync runs B1 over chunks of whole tiles: with 8
    rows a chunk, the result equals the one-chunk run and JAX's."""
    jax = jx[0]
    tcomp = tc.qsgd_kernel(8)
    shapes = {"x": (20, 512), "y": (37,)}
    grads = _to_torch(_rand_tree(shapes, 5, lead=(G,)))
    key = jax.random.PRNGKey(7)
    d = _d(shapes)
    noise = fused_draws(jx, "qsgd_kernel", key, G, d)
    outs = []
    for rows in (tdist.CHUNK_ROWS, 8):
        monkeypatch.setattr(tdist, "CHUNK_ROWS", rows)
        st = tdist.sync_state_init(tree_map(lambda g: g[0], grads), G, TSync(mode="efbv", compressor="qsgd_kernel"))
        outs.append(tdist.efbv_sync(grads, st, tcomp, 0.5, 0.7, noise=noise))
    _assert_bits(tree_map(lambda t: t.numpy(), outs[0][0]), outs[1][0], "chunked g_est")
    assert torch.equal(outs[0][1].h, outs[1][1].h)
    assert tile_rows(d) > 8                       # more than one chunk ran


# ---------------------------------------------------------------------------
# hier_param_sync and tree_param_sync
# ---------------------------------------------------------------------------
def _replicas(shapes, n, seed):
    base = _rand_tree(shapes, seed)
    rng = np.random.default_rng(seed + 1)
    return tree_map(lambda a: (a[None] + 0.05 * rng.standard_normal((n,) + a.shape)).astype(np.float32),
                    base), base


HIER_CASES = [("qsgd_kernel", BUCKET, 1), ("top_k", BUCKET, 1), ("qsgd", BUCKET, 2),
              ("identity", 0, 1), ("rand_k", 0, 2)]


@pytest.mark.parametrize("comp,bucket,period", HIER_CASES)
def test_hier_param_sync_bitwise(jx, comp, bucket, period):
    jax, jnp, _, jdist, jbase = jx
    kw = dict(mode="hier", compressor=comp, compress_ratio=0.1)
    jcomp = jdist.build_compressor(jbase.SyncConfig(**kw))
    tcomp = tdist.build_compressor(TSync(**kw))
    lam = jdist.sync_params(jbase.SyncConfig(**kw), G)[0]
    params_g, base = _replicas(SHAPES, G, 20)
    jstate = jdist.SyncState(h=(), h_bar=jax.tree_util.tree_map(jnp.asarray, base), step=jnp.zeros((), jnp.int32))
    tstate = tdist.SyncState(h=(), h_bar=_to_torch(base), step=0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params_g), _to_torch(params_g)
    fused = bool(bucket) and tcomp.flatten
    jfn = eager(jax, lambda k, p, s, m: jdist.hier_param_sync(k, p, s, jcomp, lam, period,
                                                           bucket_size=bucket, survivors=m))
    for r in range(3):
        key = jax.random.PRNGKey(200 + r)
        # local progress between syncs
        step = _rand_tree(SHAPES, 30 + r, lead=(G,))
        jp = jax.tree_util.tree_map(lambda a, b: a + 0.01 * b, jp, step)
        tp = tree_map(lambda a, b: a + 0.01 * torch.from_numpy(b), tp, step)
        _assert_bits(jp, tp, "replicas before sync")
        noise = (fused_draws(jx, comp, key, G, _d(SHAPES)) if fused
                 else leaf_draws(jx, comp, key, G, SHAPES))
        mask = np.array([1.0, 0.0 if r == 2 else 1.0], np.float32)
        jp, jstate = jfn(key, jp, jstate, jnp.asarray(mask))
        tp, tstate = tdist.hier_param_sync(tp, tstate, tcomp, lam, period, bucket_size=bucket,
                                           survivors=torch.from_numpy(mask), noise=noise)
        _assert_bits(jp, tp, f"replicas round {r}")
        _assert_bits(jstate.h_bar, tstate.h_bar, f"anchor round {r}")
        assert tstate.step == int(jstate.step)


TREE_CASES = [
    # (tree preset, level compressors leaf-most first, periods, bucket, masks)
    ("edge_fl", ("identity", "top_k"), (1, 2), BUCKET, False),
    ("edge_fl", ("identity", "top_k"), (1, 2), 0, True),
    ("edge_fl_tree", ("rand_k", "topk_block", "qsgd_kernel"), (1, 2, 4), BUCKET, False),
    ("edge_fl_tree", ("rand_k", "topk_block", "top_k"), (1, 2, 4), BUCKET, True),
    ("edge_fl_tree", ("top_k", "identity", "top_k"), (1, 2, 4), 0, True),
]


@pytest.mark.parametrize("preset,comps,periods,bucket,with_masks", TREE_CASES)
def test_tree_param_sync_bitwise(jx, preset, comps, periods, bucket, with_masks):
    jax, jnp, _, jdist, jbase = jx
    names = ("leaf", "mid", "top")[-len(comps):] if len(comps) == 3 else ("intra", "inter")
    jlev = tuple(jbase.LevelConfig(n, period=p, compressor=c, compress_ratio=0.2)
                 for n, p, c in zip(names, periods, comps))
    tlev = tuple(TLevel(n, period=p, compressor=c, compress_ratio=0.2)
                 for n, p, c in zip(names, periods, comps))
    jcas = jdist.build_cascade(jbase.SyncConfig(mode="hier", topology=preset, levels=jlev))
    tcas = tdist.build_cascade(TSync(mode="hier", topology=preset, levels=tlev))
    assert [(l.name, l.lam, l.period, l.fanout) for l in jcas] == \
        [(l.name, l.lam, l.period, l.fanout) for l in tcas]
    n = int(np.prod([l.fanout for l in tcas]))
    params_g, base = _replicas(SHAPES, n, 40)
    jstate = jdist.tree_sync_state_init(jax.tree_util.tree_map(jnp.asarray, base), jcas)
    tstate = tdist.tree_sync_state_init(_to_torch(base), tcas)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params_g), _to_torch(params_g)
    fused = bool(bucket) and all(l.compressor.flatten for l in tcas)
    L = len(tcas)
    jfn = eager(jax, lambda k, p, s, m: jdist.tree_param_sync(k, p, s, jcas, bucket_size=bucket,
                                                           survivors=m))
    rng = np.random.default_rng(50)
    for r in range(max(periods)):
        key = jax.random.PRNGKey(300 + r)
        step = _rand_tree(SHAPES, 60 + r, lead=(n,))
        jp = jax.tree_util.tree_map(lambda a, b: a + 0.01 * b, jp, step)
        tp = tree_map(lambda a, b: a + 0.01 * torch.from_numpy(b), tp, step)
        noise, n_child = [], n
        for l, lev in enumerate(tcas):
            dist_ = L - 1 - l
            lkey = key if dist_ == 0 else jax.random.fold_in(key, dist_)
            name = comps[l]
            noise.append(fused_draws(jx, name, lkey, n_child, _d(SHAPES)) if fused
                         else leaf_draws(jx, name, lkey, n_child, SHAPES))
            n_child //= lev.fanout
        masks = None
        if with_masks:
            masks, n_child = [], n
            for lev in tcas:
                m = (rng.random(n_child) > 0.3).astype(np.float32)
                masks.append(m)
                n_child //= lev.fanout
        jp, jstate = jfn(key, jp, jstate, None if masks is None else tuple(jnp.asarray(m) for m in masks))
        tp, tstate = tdist.tree_param_sync(tp, tstate, tcas, bucket_size=bucket,
                                           survivors=None if masks is None else
                                           tuple(torch.from_numpy(m) for m in masks),
                                           noise=noise)
        _assert_bits(jp, tp, f"replicas round {r}")
        for l in range(L):
            _assert_bits(jstate.anchors[l], tstate.anchors[l], f"anchor {l} round {r}")
        assert tstate.step == int(jstate.step) == r + 1


def test_xla_jit_contracts_multiply_add_and_the_port_does_not(jx):
    """Why the references above run op by op: jitted, XLA's CPU backend
    fuses ``h + lam * d`` into an FMA (one rounding); op by op, and in the
    port, it is a multiply then an add (two roundings)."""
    jax, jnp = jx[:2]
    rng = np.random.default_rng(0)
    h, d = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    lam = 0.3711
    two_ops = h + np.float32(lam) * d
    fma = (h.astype(np.float64) + np.float64(np.float32(lam)) * d.astype(np.float64)).astype(np.float32)
    jitted = np.asarray(jax.jit(lambda a, b: a + lam * b)(h, d))
    assert eager(jax, lambda a, b: a + lam * jnp.asarray(b))(h, d).tobytes() == two_ops.tobytes()
    port = torch.from_numpy(h) + lam * torch.from_numpy(d)
    assert port.numpy().tobytes() == two_ops.tobytes()
    assert (jitted == fma).all() and (jitted != two_ops).any()


def test_dense_sync_and_step_gating():
    g = {"a": torch.tensor([[1.0, 2.0], [3.0, 5.0]])}
    assert torch.equal(tdist.dense_sync(g)["a"], torch.tensor([2.0, 3.5]))
    lev = tdist.CascadeLevel("inter", tc.identity(), 1.0, 3, 2)
    p = {"a": torch.tensor([[1.0], [3.0]])}
    st = tdist.TreeSyncState(anchors=({"a": torch.tensor([0.0])},), step=0)
    for step in range(3):
        p, st = tdist.tree_param_sync(p, st, (lev,))
        want = [[2.0], [2.0]] if step == 2 else [[1.0], [3.0]]
        assert p["a"].tolist() == want and st.step == step + 1
