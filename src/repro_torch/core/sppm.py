"""SPPM-AS: stochastic proximal point with arbitrary sampling (Ch. 5).

Cohort-Squeeze's point: spend K *local communication rounds* inside the
sampled cohort to solve prox_{gamma f_C}(x_t) accurately, and the total cost
T(K)*K drops below FedAvg's best.  We implement:

  * samplings: full (FS), nice-tau (NICE), block (BS), stratified (SS) with
    k-means clustering, nonuniform single-client (NS)
  * theory quantities mu_AS, sigma*_AS^2 (Eq. 5.4) for each sampling
  * prox solvers A: gradient descent (LocalGD-like), conjugate gradient on the
    Newton system, and damped Newton ("BFGS-class" second-order baseline) —
    solver iterations = local communication rounds K
  * the SPPM-AS outer loop and the TK / hierarchical (c1*K + c2)*T cost model

Problem form: federated l2-logreg (data/federated.py), matching Ch. 5.4.

(The port's copy of ``repro/core/sppm.py``.  It is numpy host code in the
reference as well: scalar analytics and small prox solves with
data-dependent control flow, nothing for a card.  The same seeds give the
same results, bit for bit.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

# NOTE: this module is deliberately numpy-first: the paper's Ch.5 experiments
# are small convex problems where the interesting quantities (mu_AS, sigma*^2,
# TK curves) are scalar analytics; jax buys nothing and numpy keeps the prox
# solvers' control flow simple.


# ---------------------------------------------------------------------------
# Logreg oracle
# ---------------------------------------------------------------------------
def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


@dataclass
class CohortProblem:
    """f_C(x) = sum_{i in C} 1/(n p_i) f_i(x) for the sampled cohort."""
    A: np.ndarray       # (c, m, d) cohort data
    b: np.ndarray       # (c, m)
    w: np.ndarray       # (c,) client weights 1/(n p_i)
    mu: float

    def value(self, x):
        z = np.einsum("cmd,d->cm", self.A, x)
        per = np.mean(np.logaddexp(0.0, -self.b * z), axis=1) + 0.5 * self.mu * x @ x
        return float(self.w @ per)

    def grad(self, x):
        z = np.einsum("cmd,d->cm", self.A, x)
        s = -self.b * _sigmoid(-self.b * z)
        g = np.einsum("cm,cmd->cd", s, self.A) / self.A.shape[1]
        g = g + self.mu * x[None]
        return self.w @ g

    def hess(self, x):
        z = np.einsum("cmd,d->cm", self.A, x)
        sig = _sigmoid(-self.b * z)
        wgt = sig * (1 - sig) / self.A.shape[1]
        d = self.A.shape[2]
        H = np.einsum("c,cmd,cm,cme->de", self.w, self.A, wgt, self.A)
        return H + self.w.sum() * self.mu * np.eye(d)

    def smoothness(self) -> float:
        m = self.A.shape[1]
        Ls = np.sum(self.A**2, axis=(1, 2)) / (4 * m) + self.mu
        return float(self.w @ Ls)


# ---------------------------------------------------------------------------
# Samplings (Sect. 5.3.3). Each returns (list of cohort index arrays, p_i).
# ---------------------------------------------------------------------------
def nice_sampling(rng, n: int, tau: int):
    p = np.full(n, tau / n)
    draw = lambda: rng.choice(n, size=tau, replace=False)
    return draw, p


def block_sampling(rng, blocks: Sequence[np.ndarray], q: Optional[np.ndarray] = None):
    nb = len(blocks)
    q = np.full(nb, 1.0 / nb) if q is None else q
    n = sum(len(b) for b in blocks)
    p = np.zeros(n)
    for j, blk in enumerate(blocks):
        p[blk] = q[j]
    draw = lambda: blocks[rng.choice(nb, p=q)]
    return draw, p


def stratified_sampling(rng, blocks: Sequence[np.ndarray]):
    n = sum(len(b) for b in blocks)
    p = np.zeros(n)
    for blk in blocks:
        p[blk] = 1.0 / len(blk)
    draw = lambda: np.array([rng.choice(blk) for blk in blocks])
    return draw, p


def balanced_blocks(features: np.ndarray, n_blocks: int) -> List[np.ndarray]:
    """Uniform-size clusters (Assumption D.6.12) homogeneous in feature space:
    contiguous split along the top principal direction.  Lemma 5.3.4's
    sigma*_SS <= sigma*_NICE guarantee assumes uniform cluster sizes; k-means
    with unbalanced clusters can *lose* to NICE (the paper's Example D.6.13)."""
    u = np.linalg.svd(features - features.mean(0), full_matrices=False)[2][0]
    order = np.argsort(features @ u)
    return [np.sort(a) for a in np.array_split(order, n_blocks)]


def kmeans_blocks(features: np.ndarray, n_blocks: int, seed: int = 0,
                  iters: int = 50) -> List[np.ndarray]:
    """Plain k-means on client features (the paper's clustering heuristic for
    SS); returns non-empty clusters as index arrays.

    Empty clusters are re-seeded from the points farthest from their current
    centers (classic k-means++-style repair): a stale center left in place
    can shadow a live one forever, collapsing the block count — stratified
    sampling then silently draws from fewer strata than requested."""
    rng = np.random.default_rng(seed)
    n = features.shape[0]
    centers = features[rng.choice(n, size=n_blocks, replace=False)].astype(float)
    assign = np.zeros(n, dtype=int)
    for _ in range(iters):
        dist = ((features[:, None] - centers[None]) ** 2).sum(-1)
        assign = dist.argmin(1)
        nearest = dist.min(1)
        for j in range(n_blocks):
            members = assign == j
            if members.any():
                centers[j] = features[members].mean(0)
            else:
                far = int(np.argmax(nearest))
                centers[j] = features[far]
                assign[far] = j
                nearest[far] = -np.inf  # next empty cluster picks a new point
    blocks = [np.flatnonzero(assign == j) for j in range(n_blocks)]
    return [b for b in blocks if len(b)]


# ---------------------------------------------------------------------------
# Theory quantities (Eq. 5.4) — exhaustive for small cohort spaces
# ---------------------------------------------------------------------------
def sigma_star_nice(prob, x_star: np.ndarray, tau: int, n_mc: int = 512, seed: int = 0):
    """MC estimate of sigma*^2_NICE(tau) = E ||grad f_C(x*)||^2 (exact value
    via the paper's closed form (n/tau - 1)/(n-1) * sigma*^2(1) is also
    returned for cross-checking)."""
    rng = np.random.default_rng(seed)
    n = prob.n_clients
    gi = _client_grads_at(prob, x_star)            # (n, d)
    closed = (n / tau - 1) / max(n - 1, 1) * np.mean(np.sum(gi**2, axis=1))
    acc = 0.0
    for _ in range(n_mc):
        C = rng.choice(n, size=tau, replace=False)
        acc += np.sum(gi[C].mean(0) ** 2)
    return acc / n_mc, closed


def sigma_star_stratified(prob, x_star: np.ndarray, blocks, n_mc: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed)
    gi = _client_grads_at(prob, x_star)
    n = prob.n_clients
    acc = 0.0
    for _ in range(n_mc):
        g = np.zeros(gi.shape[1])
        for blk in blocks:
            i = rng.choice(blk)
            g += (len(blk) / n) * gi[i]
        acc += np.sum(g**2)
    return acc / n_mc


def _client_grads_at(prob, x):
    z = np.einsum("nmd,d->nm", prob.A, x)
    s = -prob.b * _sigmoid(-prob.b * z)
    g = np.einsum("nm,nmd->nd", s, prob.A) / prob.A.shape[1]
    return g + prob.mu * x[None]


def mu_as_nice(prob, tau: int) -> float:
    """mu_NICE(tau) = min_{|C|=tau} (1/tau) sum mu_i; with uniform mu it's mu."""
    return prob.mu  # every f_i is mu-strongly convex with the same mu


# ---------------------------------------------------------------------------
# Prox solvers (Table 5.2 / D.1): K iterations == K local communication rounds
# ---------------------------------------------------------------------------
def prox_gd(cp: CohortProblem, x0: np.ndarray, gamma: float, K: int):
    """LocalGD on phi(y) = f_C(y) + ||y - x0||^2 / (2 gamma)."""
    L_phi = cp.smoothness() + 1.0 / gamma
    lr = 1.0 / L_phi
    y = x0.copy()
    for _ in range(K):
        y = y - lr * (cp.grad(y) + (y - x0) / gamma)
    return y


def prox_newton_cg(cp: CohortProblem, x0: np.ndarray, gamma: float, K: int):
    """K CG iterations on the Newton system of phi at x0 (1st-order comm/iter)."""
    g = cp.grad(x0)  # phi'(x0) = f'_C(x0); prox term vanishes at y = x0
    H = cp.hess(x0) + np.eye(len(x0)) / gamma
    y = np.zeros_like(x0)
    r = g - H @ y
    p = r.copy()
    for _ in range(K):
        Hp = H @ p
        denom = p @ Hp
        if abs(denom) < 1e-30:
            break
        a = (r @ r) / denom
        y = y + a * p
        r_new = r - a * Hp
        beta = (r_new @ r_new) / max(r @ r, 1e-30)
        p = r_new + beta * p
        r = r_new
    return x0 - y


def prox_newton(cp: CohortProblem, x0: np.ndarray, gamma: float, K: int):
    """K damped-Newton steps (the second-order 'BFGS-class' baseline)."""
    y = x0.copy()
    for _ in range(K):
        g = cp.grad(y) + (y - x0) / gamma
        H = cp.hess(y) + np.eye(len(x0)) / gamma
        y = y - np.linalg.solve(H, g)
    return y


PROX_SOLVERS = {"gd": prox_gd, "cg": prox_newton_cg, "newton": prox_newton}


# ---------------------------------------------------------------------------
# SPPM-AS outer loop (Algorithm 8) + cost accounting
# ---------------------------------------------------------------------------
@dataclass
class SPPMResult:
    errors: np.ndarray       # ||x_t - x*||^2 per global round
    T_to_eps: Optional[int]  # rounds to reach target, None if not reached
    total_cost: Optional[float]


def sppm_as(prob, x_star: np.ndarray, draw: Callable, p: np.ndarray,
            gamma: float, K: int, T: int, solver: str = "gd",
            eps: Optional[float] = None, c_local: float = 1.0,
            c_global: float = 1.0, seed: int = 0) -> SPPMResult:
    """Run SPPM-AS; cost per global round = c_local*K + c_global (hierarchical
    FL cost model of Sect. 5.4.5; classic setting: c_local=1, c_global=0 gives
    cost TK)."""
    rng = np.random.default_rng(seed)
    n = prob.n_clients
    x = np.zeros(prob.dim)
    errs = np.empty(T)
    T_hit = None
    for t in range(T):
        C = np.asarray(draw())
        cp = CohortProblem(A=prob.A[C], b=prob.b[C], w=1.0 / (n * p[C]), mu=prob.mu)
        x = PROX_SOLVERS[solver](cp, x, gamma, K)
        errs[t] = np.sum((x - x_star) ** 2)
        if T_hit is None and eps is not None and errs[t] < eps:
            T_hit = t + 1
    cost = None if T_hit is None else T_hit * (c_local * K + c_global)
    return SPPMResult(errors=errs, T_to_eps=T_hit, total_cost=cost)


def solve_erm(prob, iters: int = 4000) -> np.ndarray:
    """High-precision x* for the full ERM objective via Newton."""
    cp = CohortProblem(A=prob.A, b=prob.b, w=np.full(prob.n_clients, 1.0 / prob.n_clients),
                       mu=prob.mu)
    x = np.zeros(prob.dim)
    for _ in range(60):
        g = cp.grad(x)
        if np.linalg.norm(g) < 1e-13:
            break
        x = x - np.linalg.solve(cp.hess(x), g)
    return x
