"""Port SymWanda (``core/symwanda.py``), the full-sequence forward and the
pruning entry point, against the JAX package.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances, with their reasons:

* scores and norms: rtol 1e-5 (sums in another order; ``** 0.5`` is
  ``sqrt`` in torch but ``pow`` on XLA's CPU);
* masks built from the SAME score matrix: bitwise (both keep every score at
  or above the k-th);
* R^2-DSnoT, 20 iterations on (256, 128): the same final mask, also with
  the reference's options (vanilla DSnoT, ``reg``, ``ria_alpha``);
* the reference's other options (``p`` = 1, 3 and inf, a given ``Y``,
  ``sample_frac``): scores rtol 1e-5 (a max is exact); masks from them at
  least 99.9% equal, each disagreement within 1e-6 of its column's k-th
  score; the global mask (``per_output=False``) from equal scores bitwise;
* reconstruction / symmetric error: rtol 1e-5;
* ``forward_train``: logits atol 2e-5 and CE within 1e-5 on the reduced f32
  h2o-danube, from the same parameters (``params_from_jax``);
* the slice (``launch/prune.prune_all_mlps`` against
  ``examples/prune_llm.py``'s, same params and batch): wanda masks equal;
  ria / symwanda masks at least 99.9% equal with every disagreement within
  1e-6 * tau_j of the port's threshold; every loss within 1e-4.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.core import symwanda as sw
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import prune as tprune
from repro_torch.models import forward_train, loss_fn

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.core import symwanda as jsw
    return jax, jnp, jsw


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(0)
    d_in, d_out, T = 256, 128, 384
    W = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    scales = np.exp(rng.standard_normal(d_in))
    X = (rng.standard_normal((T, d_in)) * scales + scales * 0.3).astype(np.float32)
    return W, X


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_norms_match_jax(jx, layer, dtype):
    _, jnp, jsw = jx
    _, X = layer
    Xt = _t(X).to(dtype)                  # the card's calibration acts are bf16
    jX = jnp.asarray(Xt.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    np.testing.assert_allclose(sw.act_norms(Xt).numpy(), np.asarray(jsw.act_norms(jX)),
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["magnitude", "wanda", "ria", "symwanda", "stochria"])
def test_scores_match_jax(jx, layer, method):
    jax, jnp, jsw = jx
    W, X = layer
    key = jax.random.PRNGKey(3)
    kw = {}
    if method == "stochria":    # the JAX draw, injected
        k = max(1, int(0.1 * X.shape[0]))
        kw = {"idx": _t(jax.random.choice(key, X.shape[0], shape=(k,), replace=False))}
    got = sw.SCORES[method](_t(W), _t(X), **kw).numpy()
    want = np.asarray(jsw.SCORES[method](jnp.asarray(W), jnp.asarray(X), key=key))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_stochria_needs_its_rows(layer):
    W, X = layer
    with pytest.raises(ValueError, match="idx="):
        sw.prune(_t(W), _t(X), method="stochria")
    idx = torch.arange(0, X.shape[0], 4)
    _, mask = sw.prune(_t(W), _t(X), method="stochria", idx=idx)
    assert torch.equal(mask, sw.mask_unstructured(sw.score_ria(_t(W), _t(X)[idx]), 0.5))


@pytest.mark.parametrize("sparsity", [0.3, 0.5, 0.6, 0.7])
def test_mask_unstructured_same_scores_bitwise(jx, layer, sparsity):
    _, jnp, jsw = jx
    W, X = layer
    S = np.array(jsw.score_wanda(jnp.asarray(W), jnp.asarray(X)))
    S[::5, :] = np.round(S[::5, :], 2)                # ties at the threshold
    got = sw.mask_unstructured(_t(S), sparsity).numpy()
    want = np.asarray(jsw.mask_unstructured(jnp.asarray(S), sparsity))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8)])
def test_mask_nm_same_scores_bitwise(jx, layer, n, m):
    _, jnp, jsw = jx
    W, X = layer
    S = np.abs(W)
    S[::3] = np.round(S[::3], 1)                      # ties inside groups
    got = sw.mask_nm(_t(S), n, m).numpy()
    assert np.array_equal(got, np.asarray(jsw.mask_nm(jnp.asarray(S), n, m)))


def test_prune_nm_structure(layer):
    W, X = layer
    _, mask = sw.prune(_t(W), _t(X), method="ria", structured_nm=(2, 4))
    assert (mask.T.reshape(W.shape[1], W.shape[0] // 4, 4).sum(-1) == 2).all()


def test_r2_dsnot_same_final_mask(jx, layer):
    _, jnp, jsw = jx
    W, X = layer
    jW, jX = jnp.asarray(W), jnp.asarray(X)
    _, jmask = jsw.prune(jW, jX, method="wanda", sparsity=0.6)
    Wd, md = sw.r2_dsnot(_t(W), _t(jmask), _t(X), sw.DSnoTConfig(iters=20))
    jWd, jmd = jsw.r2_dsnot(jW, jmask, jX, jsw.DSnoTConfig(iters=20))
    assert not np.array_equal(md.numpy(), np.asarray(jmask))    # it swapped
    assert np.array_equal(md.numpy(), np.asarray(jmd))
    assert np.array_equal(Wd.numpy(), np.asarray(jWd))
    assert float(md.mean()) == float(np.asarray(jmask).mean())  # sparsity kept


@pytest.mark.parametrize("sparsity", [0.5, 0.6])
def test_dsnot_improves_reconstruction(layer, sparsity):
    W, X = (_t(a) for a in layer)
    Wp, mask = sw.prune(W, X, method="wanda", sparsity=sparsity)
    e0 = float(sw.reconstruction_error(W, Wp, X))
    Wd, md = sw.r2_dsnot(W, mask, X, sw.DSnoTConfig(iters=30))
    assert float(sw.reconstruction_error(W, Wd, X)) < e0
    assert float(md.mean()) == float(mask.mean())


def test_errors_match_jax(jx, layer):
    _, jnp, jsw = jx
    W, X = layer
    Z = np.random.default_rng(5).standard_normal((W.shape[0], 32)).astype(np.float32)
    _, jmask = jsw.prune(jnp.asarray(W), jnp.asarray(X), method="symwanda", sparsity=0.5)
    Wp = W * np.asarray(jmask)
    np.testing.assert_allclose(
        float(sw.reconstruction_error(_t(W), _t(Wp), _t(X))),
        float(jsw.reconstruction_error(jnp.asarray(W), jnp.asarray(Wp), jnp.asarray(X))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(sw.symmetric_error(_t(W), _t(Wp), _t(X), _t(Z))),
        float(jsw.symmetric_error(jnp.asarray(W), jnp.asarray(Wp), jnp.asarray(X),
                                  jnp.asarray(Z))), rtol=1e-5)


def test_wanda_beats_magnitude(layer):
    W, X = (_t(a) for a in layer)
    e = {m: float(sw.reconstruction_error(W, sw.prune(W, X, method=m)[0], X))
         for m in ("magnitude", "wanda", "ria", "symwanda")}
    assert e["wanda"] < e["magnitude"]
    assert e["ria"] < e["magnitude"] and e["symwanda"] < e["magnitude"]


# ---------------------------------------------------------------------------
# the reference's options: lp norms, given Y, global masks, stochria's
# sample_frac, the DSnoT switches and ria_alpha
# ---------------------------------------------------------------------------
def _mask_agreement(got, want, S, tau_rtol=1e-6):
    """ROADMAP's rule for masks from scores reduced in another order: at
    least 99.9% equal, and every disagreement within ``tau_rtol`` of its
    column's k-th score."""
    differ = got != want
    assert differ.mean() <= 1e-3
    if differ.any():
        k = int(want.sum(0).min())
        tau = -np.sort(-S, axis=0)[k - 1]
        gap = np.abs(S - tau[None, :])
        assert (gap[differ] <= tau_rtol * np.broadcast_to(np.abs(tau), S.shape)[differ]).all()


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_act_norms_lp_match_jax(jx, layer, p):
    _, jnp, jsw = jx
    _, X = layer
    got, want = sw.act_norms(_t(X), p).numpy(), np.asarray(jsw.act_norms(jnp.asarray(X), p))
    if p == float("inf"):
        assert np.array_equal(got, want)          # a max is exact
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("method,p", [("wanda", 1.0), ("wanda", float("inf")),
                                      ("ria", 1.0), ("ria", float("inf"))])
def test_scores_and_masks_with_p_match_jax(jx, layer, method, p):
    _, jnp, jsw = jx
    W, X = layer
    S = sw.SCORES[method](_t(W), _t(X), p=p).numpy()
    jS = np.asarray(jsw.SCORES[method](jnp.asarray(W), jnp.asarray(X), p=p))
    np.testing.assert_allclose(S, jS, rtol=1e-5)
    _, mask = sw.prune(_t(W), _t(X), method=method, sparsity=0.5, p=p)
    _, jmask = jsw.prune(jnp.asarray(W), jnp.asarray(X), method=method, sparsity=0.5, p=p)
    _mask_agreement(mask.numpy(), np.asarray(jmask), S)


def test_symwanda_given_Y_matches_jax(jx, layer):
    _, jnp, jsw = jx
    W, X = layer
    Y = np.random.default_rng(9).standard_normal((X.shape[0], W.shape[1])).astype(np.float32)
    got = sw.score_symwanda(_t(W), _t(X), beta=0.3, Y=_t(Y)).numpy()
    want = np.asarray(jsw.score_symwanda(jnp.asarray(W), jnp.asarray(X), beta=0.3,
                                         Y=jnp.asarray(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Y defaults to X @ W
    assert torch.equal(sw.score_symwanda(_t(W), _t(X)),
                       sw.score_symwanda(_t(W), _t(X), Y=_t(X) @ _t(W)))


@pytest.mark.parametrize("sparsity", [0.3, 0.5, 0.9])
def test_mask_global_same_scores_bitwise(jx, layer, sparsity):
    _, jnp, jsw = jx
    W, X = layer
    S = np.array(jsw.score_ria(jnp.asarray(W), jnp.asarray(X)))
    S[::7, :] = np.round(S[::7, :], 3)                # ties at the threshold
    got = sw.mask_unstructured(_t(S), sparsity, per_output=False).numpy()
    want = np.asarray(jsw.mask_unstructured(jnp.asarray(S), sparsity, per_output=False))
    assert np.array_equal(got, want)
    assert got.sum() >= round((1 - sparsity) * S.size)
    assert not np.array_equal(got, sw.mask_unstructured(_t(S), sparsity).numpy())


@pytest.mark.parametrize("frac", [0.05, 0.25, 1.0])
def test_stochria_sample_frac_matches_jax(jx, layer, frac):
    jax, jnp, jsw = jx
    W, X = layer
    key = jax.random.PRNGKey(4)
    k = max(1, int(frac * X.shape[0]))
    idx = _t(jax.random.choice(key, X.shape[0], shape=(k,), replace=False))
    got = sw.score_stochria(_t(W), _t(X), sample_frac=frac, idx=idx).numpy()
    want = np.asarray(jsw.score_stochria(jnp.asarray(W), jnp.asarray(X), key=key,
                                         sample_frac=frac))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # from a generator: k distinct rows, the same for the same seed
    g = lambda: torch.Generator().manual_seed(2)
    a = sw.score_stochria(_t(W), _t(X), sample_frac=frac, generator=g())
    assert torch.equal(a, sw.score_stochria(_t(W), _t(X), sample_frac=frac, generator=g()))
    rows = torch.randperm(X.shape[0], generator=g())[:k]
    assert len(set(rows.tolist())) == k
    assert torch.equal(a, sw.score_ria(_t(W), _t(X)[rows]))


@pytest.mark.parametrize("kw,alpha", [({"use_ria_boundary": False}, 0.5),
                                      ({"reg": 0.2}, 0.5), ({}, 0.25),
                                      ({"swap_frac": 0.5, "iters": 10}, 0.5)])
def test_dsnot_options_same_final_mask(jx, layer, kw, alpha):
    _, jnp, jsw = jx
    W, X = layer
    jW, jX = jnp.asarray(W), jnp.asarray(X)
    _, jmask = jsw.prune(jW, jX, method="wanda", sparsity=0.6)
    cfg = sw.DSnoTConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jsw.DSnoTConfig(**kw))
    Wd, md = sw.r2_dsnot(_t(W), _t(jmask), _t(X), cfg, ria_alpha=alpha)
    jWd, jmd = jsw.r2_dsnot(jW, jmask, jX, jsw.DSnoTConfig(**kw), ria_alpha=alpha)
    assert not np.array_equal(md.numpy(), np.asarray(jmask))    # it swapped
    assert np.array_equal(md.numpy(), np.asarray(jmd))
    assert np.array_equal(Wd.numpy(), np.asarray(jWd))


def test_defaults_match_the_reference(jx):
    import inspect
    _, _, jsw = jx

    def defaults(fn):
        return {k: v.default for k, v in inspect.signature(fn).parameters.items()
                if v.default is not inspect.Parameter.empty and k not in ("key", "idx",
                                                                         "generator")}

    for name in ("act_norms", "score_wanda", "score_ria", "score_symwanda", "score_stochria",
                 "mask_unstructured", "mask_nm", "prune", "r2_dsnot"):
        want = defaults(getattr(jsw, name))
        if name == "r2_dsnot":
            want["cfg"] = sw.DSnoTConfig()
        assert defaults(getattr(sw, name)) == want, name
    assert dataclasses.asdict(sw.DSnoTConfig()) == dataclasses.asdict(jsw.DSnoTConfig())


# ---------------------------------------------------------------------------
# forward_train / loss_fn
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model(jx):
    jax, jnp, _ = jx
    from repro.configs import get_config
    from repro.models import init_params
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(ARCH).reduced(), dtype="float32")
    jp = init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (8, 65))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    return cfg, tcfg, jp, tp, jbatch, tbatch


def test_forward_train_and_loss_match_jax(model):
    from repro.models import forward_train as j_forward_train
    from repro.models import loss_fn as j_loss_fn
    from repro.models.layers import cross_entropy_loss as j_ce
    from repro_torch.models.layers import cross_entropy_loss
    cfg, tcfg, jp, tp, jbatch, tbatch = model
    jl, _ = j_forward_train(jp, cfg, jbatch)
    tl, aux = forward_train(tp, tcfg, tbatch)
    assert tuple(tl.shape) == tuple(jl.shape) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    ce = float(cross_entropy_loss(tl, tbatch["targets"]))
    assert abs(ce - float(j_ce(jl, jbatch["targets"]))) <= 1e-5
    loss, parts = loss_fn(tp, tcfg, tbatch)
    jloss, jparts = j_loss_fn(jp, cfg, jbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(parts["ce"]) - float(jparts["ce"])) <= 1e-5


def test_cross_entropy_masks_padded_vocab_and_ignored_targets(jx):
    _, jnp, _ = jx
    from repro.models.layers import cross_entropy_loss as j_ce
    from repro_torch.models.layers import cross_entropy_loss
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32)
    targets = rng.integers(0, 33, (3, 5))
    targets[0, :2] = -1
    got = float(cross_entropy_loss(_t(logits), _t(targets), valid_vocab=33))
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(targets), valid_vocab=33))
    assert abs(got - want) <= 1e-5


def test_prefill_is_the_last_position_of_forward_train(model):
    from repro_torch.models import prefill
    _, tcfg, _, tp, _, tbatch = model
    full, _ = forward_train(tp, tcfg, tbatch)
    last, _ = prefill(tp, tcfg, {"tokens": tbatch["tokens"]})
    # one trunk; only the unembedding's matmul shape differs
    torch.testing.assert_close(last, full[:, -1:], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the slice as a whole: launch/prune.py against examples/prune_llm.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("prune_llm_example",
                                                  ROOT / "examples" / "prune_llm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # defines functions; main() is not called
    return mod


def _w_in(params, to_np):
    return [to_np(bp["mlp"]["w_in"]) for _, bp in sorted(params["blocks"].items())]


def _port_threshold(W, X, method, sparsity):
    """The port's scores and per-column thresholds of one fused prune."""
    wp, kw, (r, c) = ops.scored_args(W, X, method, sparsity)
    tau = kw.pop("tau")[:c]
    return ref.wanda_scores_ref(wp, **kw)[:r, :c], tau


def test_calib_acts_match_example(example, model):
    cfg, tcfg, jp, tp, jbatch, tbatch = model
    np.testing.assert_allclose(tprune.calib_acts(tp, tcfg, tbatch).numpy(),
                               np.asarray(example.calib_acts(jp, cfg, jbatch)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["magnitude", "wanda", "ria", "symwanda"])
def test_prune_all_mlps_matches_example(example, model, method):
    from repro.models.layers import cross_entropy_loss as j_ce
    cfg, tcfg, jp, tp, jbatch, tbatch = model
    sparsity = 0.5
    jX = example.calib_acts(jp, cfg, jbatch)
    tX = tprune.calib_acts(tp, tcfg, tbatch)
    jpr = example.prune_all_mlps(jp, jX, method, sparsity)
    tpr = tprune.prune_all_mlps(tp, tX, method, sparsity)
    for li, (tw, jw, w0) in enumerate(zip(_w_in(tpr, lambda a: a),
                                          _w_in(jpr, np.asarray), _w_in(tp, lambda a: a))):
        for l in range(tw.shape[0]):
            tmask = (tw[l] != 0).numpy()
            jmask = jw[l] != 0
            if method in ("magnitude", "wanda"):
                assert np.array_equal(tmask, jmask), (method, li, l)
                continue
            differ = tmask != jmask
            assert differ.mean() <= 1e-3
            s, tau = _port_threshold(w0[l], tX, method, sparsity)
            gap = (s - tau[None, :]).abs().numpy()
            assert (gap[differ] <= 1e-6 * np.broadcast_to(tau.numpy(), gap.shape)[differ]).all()
    jl, _ = example.forward_train(jpr, cfg, jbatch)
    assert abs(tprune.lm_loss(tpr, tcfg, tbatch) - float(j_ce(jl, jbatch["targets"]))) <= 1e-4


def test_prune_all_mlps_dsnot_and_2_4_match_example(example, model):
    from repro.models.layers import cross_entropy_loss as j_ce
    cfg, tcfg, jp, tp, jbatch, tbatch = model
    jX = example.calib_acts(jp, cfg, jbatch)
    tX = tprune.calib_acts(tp, tcfg, tbatch)
    jpr = example.prune_all_mlps(jp, jX, "wanda", 0.6, dsnot=True)
    tpr = tprune.prune_all_mlps(tp, tX, "wanda", 0.6, dsnot=True)
    for tw, jw in zip(_w_in(tpr, lambda a: a), _w_in(jpr, np.asarray)):
        assert np.array_equal((tw != 0).numpy(), jw != 0)
    jl, _ = example.forward_train(jpr, cfg, jbatch)
    assert abs(tprune.lm_loss(tpr, tcfg, tbatch) - float(j_ce(jl, jbatch["targets"]))) <= 1e-4
    # 2:4 through B7 on wanda scores: exactly two of every four along d_in
    t24 = tprune.prune_all_mlps(tp, tX, "wanda", 0.5, structured_nm=(2, 4))
    for tw in _w_in(t24, lambda a: a):
        assert ((tw != 0).reshape(tw.shape[0], -1, 4, tw.shape[-1]).sum(2) == 2).all()


def test_prune_cli_runs_on_the_cpu(capsys):
    out = tprune.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--seed", "1"])
    labels = ["dense"] + [f"{m}@{s}" for s in tprune.SPARSITIES
                          for m in tprune.METHODS + ("wanda+R2DSnoT",)] + ["wanda@2:4"]
    assert list(out) == labels
    assert all(np.isfinite(v) for v in out.values())
    assert "dense loss" in capsys.readouterr().out


def test_prune_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprune.main(["--arch", ARCH, "--reduced"])
