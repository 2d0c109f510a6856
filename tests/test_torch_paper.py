"""The paper's federated algorithms in the port against the JAX package:
federated data, SPPM-AS / Cohort-Squeeze, EF-BV, Scafflix and FedP3.

Inputs are made from seeds with numpy and fed to both packages; every JAX
draw is injected into the port.  Tolerances, with their reasons:

* ``data/federated`` and ``core/sppm`` (numpy in both packages): bitwise.
* ``efbv_round`` and ``scafflix_round``: bitwise against the JAX functions
  run op by op (``jax.disable_jit()``), on injected gradients and draws.
  Jitted, XLA fuses ``h + lam * d`` into one FMA (``tests/test_torch_sync.py``).
* whole runs with logreg gradients inside (``einsum``, ``log1p``, ``exp``
  under XLA's fusion against torch's kernels): ``efbv_gd`` over 200 rounds
  (efbv / ef21 / diana x ``rand_k(0.1)``), objective traces within rtol
  1e-4; ``scafflix_run`` (alpha 0.1 / 0.9, 100 rounds), metric traces
  within rtol 1e-4 and the communicated rounds exactly equal.  Ledger bytes
  are exact for a given round count; the round that first reaches a gap of
  1e-3 may move by one round under ulp-level differences, and may differ
  by at most 1.
* ``fedp3_train`` (bench_fedp3's OPU3 configuration, 3 rounds, the JAX
  draws recorded and replayed): uploaded floats exactly equal, the per-round
  test loss of the global model within rtol 1e-4, the final accuracy
  within 2 of the 600 test points.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm import CommLedger, encode
from repro_torch.core import compressors as tC
from repro_torch.core import ef_bv as tef
from repro_torch.core import fedp3 as tfp
from repro_torch.core import scafflix as tsx
from repro_torch.core import sppm as tsp
from repro_torch.data import federated as tfed

torch.set_num_threads(2)
N, M, D = 16, 100, 40            # the benches' problem: 16 clients, d = 40
RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.comm import CommLedger as JLedger
    from repro.comm import encode as jencode
    from repro.core import compressors as jC
    from repro.core import ef_bv as jef
    from repro.core import fedp3 as jfp
    from repro.core import scafflix as jsx
    from repro.core import sppm as jsp
    from repro.data import federated as jfed
    return dict(jax=jax, jnp=jnp, C=jC, ef=jef, sx=jsx, fp=jfp, sp=jsp, fed=jfed,
                Ledger=JLedger, encode=jencode)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# data/federated and core/sppm: numpy in both packages, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alpha", [0.05, 0.5, 10.0])
def test_dirichlet_mixtures_bitwise(jx, alpha):
    ids = np.random.default_rng(0).integers(0, 10**6, 64)
    for client_ids in (37, ids):
        assert _bits(tfed.dirichlet_mixtures(client_ids, 10, alpha, seed=3),
                     jx["fed"].dirichlet_mixtures(client_ids, 10, alpha, seed=3))
    with pytest.raises(ValueError):
        tfed.dirichlet_mixtures(4, 3, 0.0)


def test_splits_and_logreg_clients_bitwise(jx):
    fed = jx["fed"]
    labels = np.random.default_rng(1).integers(0, 6, 500)
    for got, want in ((tfed.dirichlet_split(labels, 10, 0.5, seed=2),
                       fed.dirichlet_split(labels, 10, 0.5, seed=2)),
                      (tfed.classwise_split(labels, 10, 2, seed=2),
                       fed.classwise_split(labels, 10, 2, seed=2))):
        assert len(got) == len(want) and all(_bits(g, w) for g, w in zip(got, want))
    p, q = (m.make_logreg_clients(n_clients=N, m=M, d=D, mu=0.1, hetero=0.5, seed=0)
            for m in (tfed, fed))
    assert _bits(p.A, q.A) and _bits(p.b, q.b) and p.mu == q.mu
    assert _bits(p.smoothness(), q.smoothness()) and (p.n_clients, p.dim) == (N, D)


@pytest.fixture(scope="module")
def sppm_prob():
    return tfed.make_logreg_clients(n_clients=20, m=60, d=16, mu=0.1, hetero=0.1, seed=3)


def test_sppm_samplings_and_theory_bitwise(jx, sppm_prob):
    sp = jx["sp"]
    x_star = tsp.solve_erm(sppm_prob)
    assert _bits(x_star, sp.solve_erm(sppm_prob))
    gi = tsp._client_grads_at(sppm_prob, x_star)
    assert _bits(gi, sp._client_grads_at(sppm_prob, x_star))
    for got, want in ((tsp.balanced_blocks(gi, 8), sp.balanced_blocks(gi, 8)),
                      (tsp.kmeans_blocks(gi, 6, seed=1), sp.kmeans_blocks(gi, 6, seed=1))):
        assert len(got) == len(want) and all(_bits(g, w) for g, w in zip(got, want))
    blocks = tsp.balanced_blocks(gi, 4)
    for name, args in (("nice_sampling", (20, 8)), ("block_sampling", (blocks,)),
                       ("stratified_sampling", (blocks,))):
        d1, p1 = getattr(tsp, name)(np.random.default_rng(5), *args)
        d2, p2 = getattr(sp, name)(np.random.default_rng(5), *args)
        assert _bits(p1, p2)
        assert all(_bits(d1(), d2()) for _ in range(5))
    a, b = tsp.sigma_star_nice(sppm_prob, x_star, 8, n_mc=64), \
        sp.sigma_star_nice(sppm_prob, x_star, 8, n_mc=64)
    assert a == b
    assert tsp.sigma_star_stratified(sppm_prob, x_star, blocks, n_mc=64) == \
        sp.sigma_star_stratified(sppm_prob, x_star, blocks, n_mc=64)
    assert tsp.mu_as_nice(sppm_prob, 8) == sp.mu_as_nice(sppm_prob, 8)


@pytest.mark.parametrize("solver,K", [("gd", 2), ("cg", 4), ("newton", 1)])
def test_sppm_as_and_prox_solvers_bitwise(jx, sppm_prob, solver, K):
    sp = jx["sp"]
    x_star = tsp.solve_erm(sppm_prob)
    runs = []
    for mod in (tsp, sp):
        draw, p = mod.nice_sampling(np.random.default_rng(5), sppm_prob.n_clients, 8)
        runs.append(mod.sppm_as(sppm_prob, x_star, draw, p, 50.0, K, T=60, solver=solver,
                                eps=1e-3, c_local=0.05, c_global=1.0, seed=0))
    a, b = runs
    assert _bits(a.errors, b.errors)
    assert (a.T_to_eps, a.total_cost) == (b.T_to_eps, b.total_cost)
    C = np.arange(8)
    cp = [m.CohortProblem(A=sppm_prob.A[C], b=sppm_prob.b[C], w=np.full(8, 1 / 20), mu=0.1)
          for m in (tsp, sp)]
    x0 = np.linspace(-1, 1, sppm_prob.dim)
    assert _bits(tsp.PROX_SOLVERS[solver](cp[0], x0, 5.0, 3),
                 sp.PROX_SOLVERS[solver](cp[1], x0, 5.0, 3))
    assert cp[0].value(x0) == cp[1].value(x0) and cp[0].smoothness() == cp[1].smoothness()


# ---------------------------------------------------------------------------
# EF-BV and Scafflix rounds: bitwise against the JAX functions run op by op
# ---------------------------------------------------------------------------
def _client_uniforms(jax, key, n, d):
    """Client i's rand_k scores of a round: uniform(split(key, n)[i], (d,))."""
    return np.stack([np.asarray(jax.random.uniform(k, (d,))) for k in jax.random.split(key, n)])


@pytest.mark.parametrize("mode", ["efbv", "ef21", "diana"])
@pytest.mark.parametrize("comp", ["rand_k", "top_k", "identity"])
def test_efbv_round_bitwise_op_by_op(jx, mode, comp):
    jax, jnp, jC, jef = jx["jax"], jx["jnp"], jx["C"], jx["ef"]
    rng = np.random.default_rng(4)
    grads = rng.standard_normal((3, N, D)).astype(np.float32)
    jc, tc = ((jC.identity(), tC.identity()) if comp == "identity" else
              (getattr(jC, comp)(0.1), getattr(tC, comp)(0.1)))
    lam, nu = jef.efbv_params(jc, N, mode) if comp != "identity" else (0.7, 0.9)
    if comp != "identity":
        assert (lam, nu) == tef.efbv_params(tc, N, mode)
    jst, tst = jef.efbv_init(N, D), tef.efbv_init(N, D, device="cpu")
    for t in range(3):                    # rounds chain the state
        key = jax.random.PRNGKey(10 + t)
        with jax.disable_jit():
            jg, jst = jef.efbv_round(key, jnp.asarray(grads[t]), jst, jc, lam, nu)
        noise = _t(_client_uniforms(jax, key, N, D)) if comp == "rand_k" else None
        tg, tst = tef.efbv_round(_t(grads[t]), tst, tc, lam, nu, noise=noise)
        assert _bits(tg.numpy(), jg)
        assert _bits(tst.h.numpy(), jst.h) and _bits(tst.h_bar.numpy(), jst.h_bar)


def test_efbv_sync_worker_waits_for_multi_gpu():
    with pytest.raises(NotImplementedError, match="item 8"):
        tef.efbv_sync_worker()


@pytest.mark.parametrize("p", [0.2, 0.9])
def test_scafflix_round_bitwise_op_by_op(jx, p):
    jax, jnp, jsx = jx["jax"], jx["jnp"], jx["sx"]
    rng = np.random.default_rng(6)
    G = rng.standard_normal((N, D)).astype(np.float32)
    x0 = rng.standard_normal(D).astype(np.float32)
    x_star = rng.standard_normal((N, D)).astype(np.float32)
    alphas = rng.uniform(0.1, 0.9, N).astype(np.float32)
    gammas = rng.uniform(0.05, 0.5, N).astype(np.float32)
    jst = jsx.scafflix_init(jnp.asarray(x0), N, jnp.asarray(x_star))
    tst = tsx.scafflix_init(_t(x0), N, _t(x_star))
    comms = []
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(2), 6)):
        u = jax.random.uniform(key, ())
        with jax.disable_jit():
            jst, jcomm = jsx.scafflix_round(key, jst, lambda xt: 0.5 * xt + jnp.asarray(G),
                                            p, jnp.asarray(gammas), jnp.asarray(alphas))
        tst, tcomm = tsx.scafflix_round(tst, lambda xt: 0.5 * xt + _t(G), p, _t(gammas),
                                        _t(alphas), _t(u))
        assert bool(tcomm) == bool(jcomm) == bool(jax.random.bernoulli(key, p))
        assert _bits(tst.x.numpy(), jst.x) and _bits(tst.h.numpy(), jst.h)
        comms.append(bool(tcomm))
    if p == 0.2:                          # both branches ran
        assert any(comms) and not all(comms)


# ---------------------------------------------------------------------------
# whole runs on the federated logreg problem
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def logreg(jx):
    jnp = jx["jnp"]
    prob = tfed.make_logreg_clients(n_clients=N, m=M, d=D, mu=0.1, hetero=0.5, seed=0)
    A, b = jnp.asarray(prob.A), jnp.asarray(prob.b)
    tA, tb = _t(np.asarray(A)), _t(np.asarray(b))
    x_star = tsp.solve_erm(prob)

    def jf(x):
        z = jnp.einsum("nmd,d->nm", A, x)
        return jnp.mean(jnp.log1p(jnp.exp(-b * z))) + 0.5 * prob.mu * jnp.sum(x**2)

    def tf(x):
        z = torch.einsum("nmd,d->nm", tA, x)
        return torch.log1p(torch.exp(-tb * z)).mean() + 0.5 * prob.mu * (x**2).sum()

    Ls = prob.smoothness()
    return dict(prob=prob, A=A, b=b, tA=tA, tb=tb, jf=jf, tf=tf,
                f_star=float(jf(jnp.asarray(x_star))), Ls=Ls,
                L=float(np.mean(Ls)), Lt=float(np.sqrt(np.mean(Ls**2))))


def _hit(gaps, tol=1e-3):
    return int(np.argmax(gaps < tol)) if (gaps < tol).any() else -1


@pytest.mark.parametrize("mode", ["efbv", "ef21", "diana"])
def test_efbv_gd_matches_jax_over_200_rounds(jx, logreg, mode):
    jax, jnp, jC, jef = jx["jax"], jx["jnp"], jx["C"], jx["ef"]
    steps, mu = 200, logreg["prob"].mu
    jc, tc = jC.rand_k(0.1), tC.rand_k(0.1)
    lam, nu = tef.efbv_params(tc, N, mode)
    om_ran = tc.omega / N if mode in ("efbv", "diana") else tc.omega
    gamma = tC.efbv_stepsize(logreg["L"], logreg["Lt"], tc.eta, tc.omega, om_ran, lam, nu)
    assert gamma == jC.efbv_stepsize(logreg["L"], logreg["Lt"], jc.eta, jc.omega, om_ran,
                                     lam, nu)
    A, b, tA, tb = logreg["A"], logreg["b"], logreg["tA"], logreg["tb"]
    key = jax.random.PRNGKey(0)
    _, _, jtr = jef.efbv_gd(key, jnp.zeros(D),
                            lambda x: jx["sx"].logreg_grads(jnp.tile(x[None], (N, 1)), A, b, mu),
                            jef.efbv_init(N, D), jc, lam, nu, gamma, steps, logreg["jf"])
    noise = _t(np.stack([_client_uniforms(jax, k, N, D) for k in jax.random.split(key, steps)]))
    _, _, ttr = tef.efbv_gd(torch.zeros(D), lambda x: tsx.logreg_grads(x[None].repeat(N, 1),
                                                                      tA, tb, mu),
                            tef.efbv_init(N, D, device="cpu"), tc, lam, nu, gamma, steps,
                            logreg["tf"], noise=noise)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=RTOL)
    # the wire message and the ledger: exact for a given round count
    x = np.random.default_rng(8).standard_normal(D).astype(np.float32)
    jkey = jax.random.PRNGKey(7)
    msg = encode(tc, _t(x), noise=_t(jax.random.uniform(jkey, (D,)))).nbytes
    assert msg == jx["encode"](jc, jkey, jnp.asarray(x)).nbytes
    hits = [_hit(np.asarray(tr, np.float64) - logreg["f_star"]) for tr in (ttr.numpy(), jtr)]
    assert abs(hits[0] - hits[1]) <= 1, hits           # a threshold crossing may move
    for n_rounds in {h + 1 for h in hits if h >= 0} | {steps}:
        assert CommLedger.from_rounds(msg, n_rounds).cumulative_bytes() == \
            jx["Ledger"].from_rounds(msg, n_rounds).cumulative_bytes()


def test_efbv_gd_draws_from_a_generator_and_keeps_the_trace_on_the_device(logreg):
    tc = tC.rand_k(0.1)
    lam, nu = tef.efbv_params(tc, N, "efbv")
    run = lambda: tef.efbv_gd(torch.zeros(D), lambda x: tsx.logreg_grads(
        x[None].repeat(N, 1), logreg["tA"], logreg["tb"], 0.1), tef.efbv_init(N, D, device="cpu"),
        tc, lam, nu, 0.05, 20, logreg["tf"], generator=torch.Generator().manual_seed(1))
    (x1, _, tr1), (x2, _, tr2) = run(), run()
    assert torch.equal(x1, x2) and torch.equal(tr1, tr2) and tr1.shape == (20,)
    assert tr1[-1] < tr1[0]


@pytest.fixture(scope="module")
def flix(jx, logreg):
    """The JAX package's local optima (fed to both runs) and the port's."""
    jnp, jsx = jx["jnp"], jx["sx"]
    A, b, mu = logreg["A"], logreg["b"], logreg["prob"].mu
    x_loc = jnp.stack([jsx.local_optimum(A[i], b[i], mu, steps=40) for i in range(N)])
    t_loc = torch.stack([tsx.local_optimum(logreg["tA"][i], logreg["tb"][i], mu, steps=40)
                         for i in range(N)])
    return x_loc, t_loc


def test_local_and_flix_optima_match_jax(jx, logreg, flix):
    jnp, jsx = jx["jnp"], jx["sx"]
    x_loc, t_loc = flix
    np.testing.assert_allclose(t_loc.numpy(), np.asarray(x_loc), rtol=1e-4, atol=1e-5)
    alphas = np.full(N, 0.5, np.float32)
    mu = logreg["prob"].mu
    jo = jsx.flix_optimum(logreg["A"], logreg["b"], mu, jnp.asarray(alphas), x_loc, steps=500)
    to = tsx.flix_optimum(logreg["tA"], logreg["tb"], mu, _t(alphas), _t(np.asarray(x_loc)),
                          steps=500)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
    # flix_grad is jax.grad(flix_objective)
    x = np.random.default_rng(3).standard_normal(D).astype(np.float32)
    jgrad = jx["jax"].grad(jsx.flix_objective)(jnp.asarray(x), logreg["A"], logreg["b"], mu,
                                                jnp.asarray(alphas), x_loc)
    np.testing.assert_allclose(
        tsx.flix_grad(_t(x), logreg["tA"], logreg["tb"], mu, _t(alphas),
                      _t(np.asarray(x_loc))).numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.1, 0.9])
def test_scafflix_run_matches_jax(jx, logreg, flix, alpha):
    jax, jnp, jsx = jx["jax"], jx["jnp"], jx["sx"]
    rounds, p, mu = 100, 0.2, logreg["prob"].mu
    x_loc = flix[0]
    A, b, tA, tb = logreg["A"], logreg["b"], logreg["tA"], logreg["tb"]
    alphas = jnp.full((N,), alpha)
    gammas = jnp.asarray(1.0 / logreg["Ls"])
    key = jax.random.PRNGKey(1)
    _, (jm, jc) = jsx.scafflix_run(
        key, jsx.scafflix_init(jnp.ones(D), N, x_loc), lambda xt: jsx.logreg_grads(xt, A, b, mu),
        p, gammas, alphas, rounds,
        lambda s: jsx.flix_objective(jnp.mean(s.x, 0), A, b, mu, alphas, x_loc))
    u = _t(np.stack([np.asarray(jax.random.uniform(k, ())) for k in jax.random.split(key, rounds)]))
    ta, tg, tl = _t(np.asarray(alphas)), _t(np.asarray(gammas)), _t(np.asarray(x_loc))
    _, (tm, tcm) = tsx.scafflix_run(
        tsx.scafflix_init(torch.ones(D), N, tl), lambda xt: tsx.logreg_grads(xt, tA, tb, mu),
        p, tg, ta, rounds, lambda s: tsx.flix_objective(s.x.mean(0), tA, tb, mu, ta, tl), u=u)
    assert np.array_equal(tcm.numpy(), np.asarray(jc))          # the same rounds communicate
    assert 0 < int(tcm.sum()) < rounds
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL)


# ---------------------------------------------------------------------------
# FedP3: bench_fedp3's OPU3 configuration with the JAX draws replayed
# ---------------------------------------------------------------------------
SIZES = [24, 64, 64, 48, 6]
N_TEST = 600


class Replay:
    """A draw source that hands out the JAX package's recorded draws in
    order, checking each one's kind and shape."""

    def __init__(self, recorded):
        self.recorded, self.i = recorded, 0

    def _next(self, kind, shape):
        k, a = self.recorded[self.i]
        self.i += 1
        assert (k, a.shape) == (kind, tuple(shape)), (self.i, k, a.shape, kind, shape)
        return torch.from_numpy(a.copy())

    def normal(self, shape, device):
        return self._next("normal", shape).to(device)

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        return self._next("uniform", shape).to(device)

    def randint(self, shape, device, low, high):
        return self._next("randint", shape).long().to(device)


@pytest.fixture(scope="module")
def fed_data():
    X, y = tfp.make_classification(n=2400, d=24, nclass=6, seed=0)
    Xte, yte = tfp.make_classification(n=N_TEST, d=24, nclass=6, seed=1)
    idx = tfed.dirichlet_split(y, 10, alpha=0.5, seed=0)
    return [X[i] for i in idx], [y[i] for i in idx], Xte, yte


def test_make_classification_bitwise(jx):
    for kw in ({}, {"label_noise": 0.2, "seed": 4}):
        a, b = tfp.make_classification(n=300, **kw), jx["fp"].make_classification(n=300, **kw)
        assert _bits(a[0], b[0]) and _bits(a[1], b[1])


def _record_eval(monkeypatch, module, is_eval, to_np):
    """Wrap ``module.mlp_apply`` to keep the global params it is called with
    on the test set (once per round)."""
    seen, inner = [], module.mlp_apply

    def wrapped(layers, x):
        if is_eval(x):
            seen.append([{k: to_np(v) for k, v in l.items()} for l in layers])
        return inner(layers, x)

    monkeypatch.setattr(module, "mlp_apply", wrapped)
    return seen


def _test_losses(param_trace, Xte, yte):
    out = []
    for layers in param_trace:
        tl = [{k: _t(v) for k, v in l.items()} for l in layers]
        out.append(float(tfp.xent(tl, torch.from_numpy(Xte), torch.from_numpy(yte).long(), 6)))
    return np.asarray(out)


@pytest.mark.parametrize("kw", [{}, {"local_strategy": "ordered_dropout", "ldp_sigma": 0.01},
                                {"local_strategy": "uniform", "aggregation": "weighted"}])
def test_fedp3_train_matches_jax_with_replayed_draws(jx, fed_data, monkeypatch, kw):
    jax, jfp = jx["jax"], jx["fp"]
    Xs, Ys, Xte, yte = fed_data
    base = dict(n_clients=10, clients_per_round=5, layers_per_client=3,
                global_prune_ratio=0.9, local_steps=4, lr=0.2, seed=0)
    rounds = 3
    recorded = []
    for kind in ("normal", "uniform", "randint"):
        def rec(*a, _f=getattr(jax.random, kind), _k=kind, **k):
            out = _f(*a, **k)
            recorded.append((_k, np.asarray(out)))
            return out
        monkeypatch.setattr(jax.random, kind, rec)
    from jax.core import Tracer
    jseen = _record_eval(monkeypatch, jfp, lambda x: not isinstance(x, Tracer)
                         and x.shape[0] == N_TEST, np.asarray)
    jacc, jup, _ = jfp.fedp3_train(jfp.FedP3Config(**base, **kw), Xs, Ys, SIZES, rounds, Xte, yte)
    monkeypatch.undo()
    tseen = _record_eval(monkeypatch, tfp, lambda x: x.shape[0] == N_TEST,
                         lambda v: v.detach().numpy())
    replay = Replay(recorded)
    tacc, tup, tparams = tfp.fedp3_train(tfp.FedP3Config(**base, **kw), Xs, Ys, SIZES, rounds,
                                         Xte, yte, draws=replay, device="cpu")
    monkeypatch.undo()
    assert replay.i == len(recorded)                  # every JAX draw, in order
    assert np.array_equal(tup, jup) and tup.dtype == jup.dtype
    led = [CommLedger(), jx["Ledger"]()]
    for t in range(rounds):
        for L, up in zip(led, (tup, jup)):
            L.record(t, "clients->server", (up[t] - (up[t - 1] if t else 0.0)) * 4)
    assert led[0].bytes_by_round() == led[1].bytes_by_round()
    assert len(tseen) == len(jseen) == rounds
    np.testing.assert_allclose(_test_losses(tseen, Xte, yte), _test_losses(jseen, Xte, yte),
                               rtol=RTOL)
    assert abs(tacc[-1] - jacc[-1]) <= 2 / N_TEST + 1e-9
    assert len(tparams) == len(SIZES) - 1


def test_fedp3_draws_from_a_generator(fed_data):
    Xs, Ys, Xte, yte = fed_data
    cfg = tfp.FedP3Config(n_clients=10, clients_per_round=5, local_strategy="uniform",
                          ldp_sigma=0.01, lr=0.2)
    a = tfp.fedp3_train(cfg, Xs, Ys, SIZES, 3, Xte, yte, device="cpu")
    b = tfp.fedp3_train(cfg, Xs, Ys, SIZES, 3, Xte, yte, device="cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[0][-1] > 1 / 6                          # it learns
    if not torch.cuda.is_available():                # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfp.fedp3_train(cfg, Xs, Ys, SIZES, 1, Xte, yte)


# ---------------------------------------------------------------------------
# the example entry points, small, on the CPU
# ---------------------------------------------------------------------------
EXAMPLES = ("quickstart", "train_e2e", "prune_llm", "federated_logreg", "cohort_squeeze")


def _example(name):
    import importlib
    return importlib.import_module(f"repro_torch.examples.{name}")


def test_federated_logreg_example_runs_small_on_the_cpu():
    out = _example("federated_logreg").main(["--device", "cpu", "--efbv-rounds", "40",
                                             "--scafflix-rounds", "40", "--flix-steps", "200"])
    for mode, r in out["efbv"].items():
        assert r["trace"].shape == (40,) and np.isfinite(r["trace"]).all()
        assert r["trace"][-1] < r["trace"][0]
        assert r["ledger"].total_bytes == r["msg_bytes"] * (40 if r["hit"] < 0 else r["hit"] + 1)
    for alpha, r in out["scafflix"].items():
        assert r["comms"].dtype == bool and 0 < r["comms"].sum() < 40


def test_cohort_squeeze_example_matches_the_reference(jx):
    ex = _example("cohort_squeeze")
    out = ex.main(["--device", "cpu"])
    prob, x_star = ex.problem()
    sp = jx["sp"]
    for K, cost in out["fig5.1"][50.0].items():      # the reference's SPPM, same draws
        draw, p = sp.nice_sampling(np.random.default_rng(5), prob.n_clients, 8)
        assert cost == sp.sppm_as(prob, x_star, draw, p, 50.0, K, T=300, solver="gd",
                                  eps=1e-3, c_global=0.0, seed=0).total_cost
    assert out["fig5.1"][50.0][2] < out["fig5.1"][50.0][1]   # K=2 beats FedAvg's K=1


def test_lm_examples_run_small_on_the_cpu(tmp_path):
    q = _example("quickstart").main(["--steps", "3", "--sync", "local", "--device", "cpu"])
    assert len(q["tokens"]) == 16 and q["cost"].total_bytes > 0
    e = _example("train_e2e").main(["--steps", "3", "--d-model", "64", "--layers", "2",
                                    "--seq", "32", "--batch", "2", "--sync", "hier",
                                    "--ckpt", str(tmp_path / "e2e"), "--device", "cpu"])
    assert np.isfinite(e["eval_loss"]) and (tmp_path / "e2e.npz").exists()
    ladder = _example("prune_llm").main(["--steps", "3", "--ckpt", str(tmp_path / "p"),
                                         "--device", "cpu"])
    assert list(ladder)[0] == "dense" and len(ladder) == 12
    assert all(np.isfinite(v) for v in ladder.values())


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
