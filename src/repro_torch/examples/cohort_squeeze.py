"""Cohort-Squeeze demo (Ch. 5): squeeze more out of each cohort
(counterpart of ``examples/cohort_squeeze.py``).

    PYTHONPATH=src python -m repro_torch.examples.cohort_squeeze [--device cpu]

The TK-vs-K trade-off (Fig 5.1), the sampling-strategy comparison (Fig 5.3)
and the hierarchical-FL cost model (Fig 5.6).  SPPM-AS is numpy host code
in both packages (``core/sppm.py``), so the numbers equal the reference's;
``--device`` is resolved like every entry point's, and nothing here runs
on it.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.sppm import (_client_grads_at, balanced_blocks, nice_sampling,
                                   sigma_star_nice, sigma_star_stratified, solve_erm,
                                   sppm_as, stratified_sampling)
from repro_torch.data.federated import make_logreg_clients

GAMMAS = (5.0, 50.0, 500.0)
KS = (1, 2, 4, 8, 16)


def problem():
    prob = make_logreg_clients(n_clients=20, m=60, d=16, mu=0.1, hetero=0.1, seed=3)
    return prob, solve_erm(prob)


def fig_5_1(prob, x_star, gamma: float, eps: float = 1e-3, T: int = 300) -> dict:
    """Total communication T(K) K to reach ``eps`` for each K -> {K: cost or
    None}."""
    row = {}
    for K in KS:
        draw, p = nice_sampling(np.random.default_rng(5), prob.n_clients, 8)
        row[K] = sppm_as(prob, x_star, draw, p, gamma, K, T=T, solver="gd", eps=eps,
                         c_global=0.0, seed=0).total_cost
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.utils.device import resolve_device

    resolve_device(args.device)
    prob, x_star = problem()
    eps = 1e-3
    out = {"fig5.1": {}}
    print("== Fig 5.1: total communication TK vs local rounds K ==")
    for gamma in GAMMAS:
        row = out["fig5.1"][gamma] = fig_5_1(prob, x_star, gamma, eps)
        print(f"  gamma={gamma:6.1f}  " + "  ".join(f"K={K}:{c if c else 'inf'}"
                                                    for K, c in row.items()))
    print("  (K=2 local rounds beat FedAvg's K=1: ~22% less total communication)")

    print("== Fig 5.3 / Lemma 5.3.4: sampling strategies ==")
    gi = _client_grads_at(prob, x_star)
    blocks = balanced_blocks(gi, 8)
    s_nice, _ = sigma_star_nice(prob, x_star, tau=8)
    s_ss = sigma_star_stratified(prob, x_star, blocks)
    out["fig5.3"] = (s_nice, s_ss)
    print(f"  sigma*^2 NICE={s_nice:.3e}  stratified={s_ss:.3e} (SS <= NICE: {s_ss <= s_nice})")

    print("== Fig 5.6: hierarchical FL (c_local=0.05, c_global=1) ==")
    best, ref = (None, np.inf), None
    for K in KS:
        draw, p = nice_sampling(np.random.default_rng(5), prob.n_clients, 8)
        r = sppm_as(prob, x_star, draw, p, 50.0, K, T=300, solver="gd", eps=eps,
                    c_local=0.05, c_global=1.0, seed=0)
        cost = r.total_cost if r.total_cost is not None else np.inf
        if K == 1:
            ref = cost
        if cost < best[1]:
            best = (K, cost)
    out["fig5.6"] = (best, ref)
    print(f"  best K={best[0]} cost={best[1]:.2f} vs FedAvg(K=1)={ref:.2f} "
          f"-> {100 * (1 - best[1] / ref):.0f}% saving")
    return out


if __name__ == "__main__":
    main()
