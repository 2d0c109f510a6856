"""The port's Mamba2 SSD block and MoE layer (``repro_torch/models/{mamba,
moe}.py``) against the JAX package's, unit by unit, on the same inputs.

Tolerances:
- ``_causal_conv``, ``mamba_decode`` and ``moe_ffn``: atol 2e-5 in f32 (the
  same operations in the same order; matmuls and einsums may sum in another
  order).
- The SSD chunked scan: the port loops over chunks where JAX runs an
  associative (tree) scan, so additions differ in order; held to 1e-4
  relative to the output's max, the JAX package's own decode-vs-forward bound
  (``tests/test_arch_smoke.py``).  Against the naive recurrence, atol 1e-3
  as the JAX package's ``test_ssd_matches_recurrence``.
- MoE routing ties: ``torch.topk`` does not promise JAX's lower-index-first
  order on ties, so every MoE test draws continuous inputs and asserts that
  adjacent sorted router probabilities (through rank K + 1) differ by more
  than 1e-5, far above f32 rounding; the dropped (token, k) pairs are then
  compared exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import MambaConfig
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.interop import params_from_jax

torch.set_num_threads(2)
ATOL = 2e-5
SSD_REL = 1e-4
MARGIN = 1e-5
MCFG = MambaConfig(d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=8)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.models import mamba as jmamba
    from repro.models import moe as jmoe
    return jax, jnp, jmamba, jmoe


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np_tree(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def _mamba_params(jx, d_model=16, cfg=MCFG, seed=0):
    jax, jnp, jmamba, _ = jx
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), d_model, cfg, jnp.float32)
    # non-trivial conv bias, dt bias and D so every term is exercised
    rng = np.random.default_rng(seed + 100)
    dims = jmamba.mamba_dims(d_model, cfg)
    jp = dict(jp, conv_b=jnp.asarray(rng.normal(0, 0.1, dims["conv_dim"]), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(-1.0, 0.5, dims["n_heads"]), jnp.float32),
              D=jnp.asarray(rng.uniform(0.5, 1.5, dims["n_heads"]), jnp.float32))
    return jp, params_from_jax(_np_tree(jax, jp), device="cpu")


@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv_matches_jax(jx, S):
    jax, jnp, jmamba, _ = jx
    jp, tp = _mamba_params(jx)
    conv_dim = jmamba.mamba_dims(16, MCFG)["conv_dim"]
    x = np.random.default_rng(S).normal(size=(2, S, conv_dim)).astype(np.float32)
    want = jmamba._causal_conv(jp, jnp.asarray(x), MCFG)
    got = tmamba._causal_conv(tp, _t(x), MCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _ssd_inputs(seed, S, H=4, hd=4, G=2, N=8, B=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, dt_raw, B_, C_ = f(B, S, H, hd), f(B, S, H), f(B, S, G, N), f(B, S, G, N)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)       # softplus
    A = (-np.exp(0.3 * f(H))).astype(np.float32)
    D = rng.uniform(0.5, 1.5, H).astype(np.float32)
    return x, dt, A, B_, C_, D


@pytest.mark.parametrize("chunk", [4, 8, 12, 24])
def test_ssd_chunked_matches_jax(jx, chunk):
    jax, jnp, jmamba, _ = jx
    args = _ssd_inputs(chunk, 24)
    jy, js = jmamba._ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, ts = tmamba._ssd_chunked(*map(_t, args), chunk)
    assert _rel(ty.numpy(), jy) < SSD_REL and _rel(ts.numpy(), js) < SSD_REL


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 4), (2, 8), (3, 8)])
def test_ssd_matches_recurrence(seed, chunk):
    """The port's own counterpart of the JAX package's test: the chunked
    scan equals the naive sequential recurrence (one group)."""
    x, dt, A, B_, C_, D = _ssd_inputs(seed, 24, H=2, hd=4, G=1, N=8, B=1)
    D = np.ones_like(D)
    y, state = tmamba._ssd_chunked(*map(_t, (x, dt, A, B_, C_, D)), chunk)
    h = np.zeros((1, 2, 4, 8))
    ys = np.zeros((1, 24, 2, 4))
    for t in range(24):
        da = np.exp(dt[:, t] * A)
        h = h * da[..., None, None] + np.einsum("bh,bhd,bn->bhdn", dt[:, t], x[:, t],
                                                B_[:, t, 0])
        ys[:, t] = np.einsum("bhdn,bn->bhd", h, C_[:, t, 0]) + x[:, t]
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-3)
    np.testing.assert_allclose(state.numpy(), h, atol=1e-3)


@pytest.mark.parametrize("S", [1, 2, 3, 8, 21, 24])
def test_mamba_forward_and_cache_match_jax(jx, S):
    """Whole chunks (8, 24), a padded tail (21 % 8), one short chunk (S <
    chunk_size) and prompts shorter than d_conv - 1 (1, 2), whose conv cache
    is left-padded."""
    jax, jnp, jmamba, _ = jx
    jp, tp = _mamba_params(jx)
    u = np.random.default_rng(S).normal(size=(2, S, 16)).astype(np.float32)
    jo, jc = jmamba.mamba_forward(jp, jnp.asarray(u), MCFG, 16, return_cache=True)
    to, tc = tmamba.mamba_forward(tp, _t(u), MCFG, 16, return_cache=True)
    assert _rel(to.numpy(), jo) < SSD_REL
    assert _rel(tc["ssm"].numpy(), jc["ssm"]) < SSD_REL
    assert tc["conv"].shape == jc["conv"].shape == (2, MCFG.d_conv - 1, tc["conv"].shape[2])
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    assert torch.equal(tmamba.mamba_train(tp, _t(u), MCFG, 16), to)


def test_mamba_decode_matches_jax(jx):
    jax, jnp, jmamba, _ = jx
    jp, tp = _mamba_params(jx)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(2, 11, 16)).astype(np.float32)
    _, jc = jmamba.mamba_forward(jp, jnp.asarray(u), MCFG, 16, return_cache=True)
    tc = {k: _t(v) for k, v in jc.items()}                  # the same cache
    for step in range(3):
        ut = rng.normal(size=(2, 1, 16)).astype(np.float32)
        jo, jc = jmamba.mamba_decode(jp, jnp.asarray(ut), jc, MCFG, 16)
        to, tc = tmamba.mamba_decode(tp, _t(ut), tc, MCFG, 16)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))


def test_mamba_init_layout_and_dtypes(jx):
    """bf16 model: a_log, dt_bias and D stay f32 leaves; shapes equal JAX's."""
    jax, jnp, jmamba, _ = jx
    jp = jax.eval_shape(lambda: jmamba.init_mamba(jax.random.PRNGKey(0), 16, MCFG,
                                                  jnp.bfloat16))
    tp = tmamba.init_mamba(torch.Generator().manual_seed(0), 16, MCFG, torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        got = tp[k]["scale"] if k == "norm" else tp[k]
        want = jp[k]["scale"] if k == "norm" else jp[k]
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    spec = tmamba.mamba_cache_spec(16, MCFG, 3, torch.bfloat16)
    jspec = jmamba.mamba_cache_spec(16, MCFG, 3, jnp.bfloat16)
    for k in ("ssm", "conv"):
        assert tuple(spec[k].shape) == jspec[k].shape
        assert str(spec[k].dtype).split(".")[-1] == str(jspec[k].dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_world(jx, E, d, ff, gated, shared, seed=0):
    jax, jnp, _, jmoe = jx
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, E, gated, shared, jnp.float32)
    # a router wide enough that the sorted probabilities are well separated
    jp = dict(jp, router=jp["router"] * 10.0)
    return jp, params_from_jax(_np_tree(jax, jp), device="cpu")


def _assert_margins(router, x, K):
    """Adjacent sorted router probabilities through rank K+1 are > MARGIN
    apart, so top-k and its order cannot flip on rounding."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(router, np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), -1)[:, ::-1]
    upto = min(K + 1, p.shape[1])
    assert np.min(-np.diff(p[:, :upto], axis=-1)) > MARGIN


def _jax_dropped(jx, jp, x, E, K, cf, no_drop):
    """The reference's dropped (token, k) pairs: the rank lines of
    ``repro/models/moe.py:moe_ffn``, run in jnp."""
    jax, jnp = jx[:2]
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    T = xt.shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, gate_i = jax.lax.top_k(probs, K)
    C = T if no_drop else max(1, int(T * K * cf / E))
    flat_e = gate_i.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    first_pos = jnp.searchsorted(sorted_e, jnp.arange(E))
    rank_sorted = jnp.arange(T * K) - first_pos[sorted_e]
    rank = jnp.zeros((T * K,), jnp.int32).at[sort_idx].set(rank_sorted.astype(jnp.int32))
    return {(int(i) // K, int(i) % K) for i in np.flatnonzero(np.asarray(rank >= C))}


MOE_CASES = [(gated, shared, K, no_drop) for gated in (True, False) for shared in (False, True)
             for K in (1, 2, 4) for no_drop in (False, True)]


@pytest.mark.parametrize("gated,shared,K,no_drop", MOE_CASES,
                         ids=[f"{'gated' if g else 'plain'}-{'shared' if s else 'routed'}-"
                              f"top{k}-{'nodrop' if n else 'cap'}" for g, s, k, n in MOE_CASES])
def test_moe_ffn_matches_jax(jx, gated, shared, K, no_drop):
    jax, jnp, _, jmoe = jx
    E, d, ff, cf = 4, 16, 24, 1.0
    jp, tp = _moe_world(jx, E, d, ff, gated, shared, seed=K)
    x = np.random.default_rng(10 + K).normal(size=(2, 12, d)).astype(np.float32)
    _assert_margins(jp["router"], x, K)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, act="silu" if gated else "relu2",
              gated=gated, shared_expert=shared, no_drop=no_drop)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), **kw)
    ty, taux = tmoe.moe_ffn(tp, _t(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
    r = tmoe.route(tp["router"], _t(x).reshape(-1, d), E, K, cf, no_drop)
    dropped = {(int(i) // K, int(i) % K) for i in torch.nonzero(~r.keep).flatten()}
    assert dropped == _jax_dropped(jx, jp, x, E, K, cf, no_drop)
    assert (r.dropped == 0) if no_drop else r.dropped == len(dropped)
    if not no_drop and 1 < K < E:
        assert r.dropped > 0          # capacity 1.0 at 1 < K < E drops here (at K = E
                                      # every expert takes each token once: none)


def test_moe_gelu_gated_and_silu_plain_experts_match_jax(jx):
    """The reference's expert activations off the common path: gated "gelu"
    (tanh form) and ungated "silu" (any act but relu2)."""
    jax, jnp, _, jmoe = jx
    x = np.random.default_rng(3).normal(size=(1, 10, 16)).astype(np.float32)
    for gated, act in ((True, "gelu"), (False, "silu")):
        jp, tp = _moe_world(jx, 4, 16, 24, gated, True, seed=3)
        _assert_margins(jp["router"], x, 2)
        kw = dict(num_experts=4, top_k=2, capacity_factor=1.25, act=act, gated=gated,
                  shared_expert=True)
        jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), **kw)
        ty, _ = tmoe.moe_ffn(tp, _t(x), **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)


def _port_moe(E, d, ff, seed):
    g = torch.Generator().manual_seed(seed)
    return tmoe.init_moe(g, d, ff, E, True, False, torch.float32, "cpu")


def test_moe_no_drop_routes_everything():
    E, K, d = 4, 2, 32
    params = _port_moe(E, d, 64, 0)
    x = torch.randn((2, 8, d), generator=torch.Generator().manual_seed(1))
    y, aux = tmoe.moe_ffn(params, x, num_experts=E, top_k=K, capacity_factor=1.0,
                          act="silu", gated=True, shared_expert=False, no_drop=True)
    assert y.shape == x.shape
    assert tmoe.route(params["router"], x.reshape(-1, d), E, K, 1.0, True).dropped == 0
    assert float(aux) >= 1.0 - 1e-5   # the Switch aux loss is 1 at balance, else more


def test_moe_capacity_drops_tokens():
    """With a tiny capacity, outputs differ from the roomy result."""
    E, K, d = 4, 1, 16
    params = _port_moe(E, d, 32, 0)
    x = torch.randn((1, 32, d), generator=torch.Generator().manual_seed(1))
    kw = dict(num_experts=E, top_k=K, act="silu", gated=True, shared_expert=False)
    y_full, _ = tmoe.moe_ffn(params, x, capacity_factor=4.0, **kw)
    y_tight, _ = tmoe.moe_ffn(params, x, capacity_factor=0.25, **kw)
    assert float((y_full - y_tight).abs().max()) > 1e-6
    assert tmoe.route(params["router"], x.reshape(-1, d), E, K, 0.25).dropped > 0


def test_moe_matches_dense_expert_sum():
    """no_drop top-E routing == the gate-weighted sum over all experts
    computed densely (atol 1e-4, as the JAX package's test)."""
    E, d, ff = 3, 16, 24
    params = _port_moe(E, d, ff, 2)
    x = torch.randn((1, 5, d), generator=torch.Generator().manual_seed(3))
    y, _ = tmoe.moe_ffn(params, x, num_experts=E, top_k=E, capacity_factor=1.0,
                        act="silu", gated=True, shared_expert=False, no_drop=True)
    xt = x.reshape(-1, d)
    w = torch.softmax(xt @ params["router"], -1)
    dense = torch.zeros_like(xt)
    for e in range(E):
        h = xt @ params["w_in"][e]
        g = xt @ params["w_gate"][e]
        dense += w[:, e:e + 1] * ((torch.nn.functional.silu(g) * h) @ params["w_out"][e])
    np.testing.assert_allclose(y.reshape(-1, d).numpy(), dense.numpy(), atol=1e-4)


@pytest.mark.parametrize("impl", ["alltoall", "shardmap"])
def test_moe_apply_on_a_mesh_raises_naming_item_8(impl):
    """The expert-parallel paths (Queue 1, item 8d) run on a DTensor input
    on the launcher's mesh (``tests/test_torch_moe_ep.py``); handed a plain
    tensor they raise rather than fall back to the scatter path.  Without
    specs the dispatcher takes the scatter path."""
    params = _port_moe(4, 8, 16, 0)
    x = torch.zeros((1, 4, 8))
    kw = dict(num_experts=4, top_k=1, capacity_factor=1.0, act="silu", gated=True,
              shared_expert=False)
    with pytest.raises(ValueError, match="DTensor input"):
        tmoe.moe_apply(params, x, specs={"impl": impl}, **kw)
    y, _ = tmoe.moe_apply(params, x, **kw)                 # no mesh: the scatter path
    assert torch.equal(y, tmoe.moe_ffn(params, x, **kw)[0])


def test_moe_combine_repeats_bit_for_bit():
    """The combine has no atomics: two runs of top-4 routing are equal bit
    for bit (the property the card's delta-vs-materialized check needs)."""
    g = torch.Generator().manual_seed(4)
    params = tmoe.init_moe(g, 16, 32, 8, True, False, torch.bfloat16, "cpu")
    x = torch.randn((2, 9, 16), generator=g).to(torch.bfloat16)
    kw = dict(num_experts=8, top_k=4, capacity_factor=1.25, act="silu", gated=True,
              shared_expert=False)
    a, _ = tmoe.moe_ffn(params, x, **kw)
    b, _ = tmoe.moe_ffn(params, x.clone(), **kw)
    assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))

