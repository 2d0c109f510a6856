"""Federated convex benchmark: EF-BV vs EF21 vs DIANA, and Scafflix
(counterpart of ``examples/federated_logreg.py``; Fig. 2.2 and Fig. 3.1).

    PYTHONPATH=src python -m repro_torch.examples.federated_logreg [--device cpu]

16 l2-regularized logistic-regression clients (d = 40).  EF-BV, EF21 and
DIANA under ``rand_k(0.1)`` for 800 rounds report the bits to a gap of 1e-3
from the exact wire size of one client's payload (``comm.encode``) and the
ledger; Scafflix at alpha 0.1 / 0.5 / 0.9 (p = 0.2) reports the gap after
400 rounds and the rounds that communicated.

Draws: every compressor score and every Scafflix coin comes from one CPU
``torch.Generator`` seeded from ``--seed`` and is moved to the device, so a
run on the card and a run on the CPU take the same draws.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.comm import CommLedger, encode
from repro_torch.core import compressors as C
from repro_torch.core.ef_bv import efbv_gd, efbv_init, efbv_params
from repro_torch.core.scafflix import (flix_objective, flix_optimum, local_optimum,
                                       logreg_grads, scafflix_init, scafflix_run)
from repro_torch.core.sppm import solve_erm
from repro_torch.data.federated import make_logreg_clients
from repro_torch.obs.trace import wall_s

MODES = ("efbv", "ef21", "diana")
ALPHAS = (0.1, 0.5, 0.9)
GAP = 1e-3


def problem(device):
    """The example's 16 clients, their data as f32 tensors on ``device``, the
    ERM optimum's objective and the smoothness constants."""
    prob = make_logreg_clients(n_clients=16, m=100, d=40, mu=0.1, hetero=0.5, seed=0)
    A = torch.as_tensor(prob.A, dtype=torch.float32, device=device)
    b = torch.as_tensor(prob.b, dtype=torch.float32, device=device)

    def f_fn(x):
        z = torch.einsum("nmd,d->nm", A, x)
        return torch.log1p(torch.exp(-b * z)).mean() + 0.5 * prob.mu * (x**2).sum()

    x_star = torch.as_tensor(solve_erm(prob), dtype=torch.float32, device=device)
    return dict(prob=prob, A=A, b=b, f_fn=f_fn, f_star=float(f_fn(x_star)),
                Ls=prob.smoothness())


def first_hit(gaps: np.ndarray, tol: float = GAP) -> int:
    """The first round whose gap is under ``tol``, or -1."""
    return int(np.argmax(gaps < tol)) if (gaps < tol).any() else -1


def efbv_runs(pb: dict, device, rounds: int = 800, seed: int = 0, log=print) -> dict:
    """EF-BV / EF21 / DIANA under rand_k(0.1) -> {mode: {lam, nu, gamma,
    trace (np), hit, msg_bytes, ledger, seconds}}; the ledger holds one
    message per round up to the first hit (all rounds without one);
    ``seconds`` is the run's, on the host clock, to its trace's read-back."""
    A, b, mu = pb["A"], pb["b"], pb["prob"].mu
    n, _, d = A.shape
    Ls = pb["Ls"]
    L, Lt = float(np.mean(Ls)), float(np.sqrt(np.mean(Ls**2)))
    comp = C.rand_k(0.1)
    gen = torch.Generator().manual_seed(seed)
    # one client's payload: its exact wire size (repro_torch.comm)
    msg_bytes = encode(comp, torch.randn(d, generator=gen).to(device),
                       noise=torch.rand(d, generator=gen).to(device)).nbytes
    grad_fn = lambda x: logreg_grads(x[None].expand(n, -1), A, b, mu)
    out = {}
    for mode in MODES:
        lam, nu = efbv_params(comp, n, mode)
        om_ran = comp.omega / n if mode in ("efbv", "diana") else comp.omega
        gamma = C.efbv_stepsize(L, Lt, comp.eta, comp.omega, om_ran, lam, nu)
        noise = torch.rand((rounds, n, d), generator=gen).to(device)
        t0 = wall_s()
        _, _, tr = efbv_gd(torch.zeros(d, device=device), grad_fn, efbv_init(n, d, device=device),
                           comp, lam, nu, gamma, rounds, pb["f_fn"], noise=noise)
        trace = tr.double().cpu().numpy()            # waits for the run
        seconds = wall_s() - t0
        hit = first_hit(trace - pb["f_star"])
        ledger = CommLedger.from_rounds(msg_bytes, rounds if hit < 0 else hit + 1)
        out[mode] = dict(lam=lam, nu=nu, gamma=gamma, trace=trace, hit=hit,
                         msg_bytes=msg_bytes, ledger=ledger, seconds=seconds)
        msg = (f"bits-to-{GAP:g} = {ledger.cumulative_bytes()[hit] * 8} (round {hit + 1})"
               if hit >= 0 else f"gap {trace[-1] - pb['f_star']:.2e}")
        log(f"  {mode:6s} lam={lam:.3f} nu={nu:.3f} gamma={gamma:.4f}  {msg}")
    return out


def scafflix_runs(pb: dict, device, rounds: int = 400, p: float = 0.2, seed: int = 1,
                  flix_steps: int = 20000, alphas=ALPHAS, log=print) -> dict:
    """Scafflix at each alpha -> {alpha: {trace (np), comms (np bool), fstar,
    seconds (the run's alone, as in ``efbv_runs``)}}."""
    A, b, mu = pb["A"], pb["b"], pb["prob"].mu
    n, _, d = A.shape
    gen = torch.Generator().manual_seed(seed)
    x_loc = torch.stack([local_optimum(A[i], b[i], mu) for i in range(n)])
    gammas = torch.as_tensor(1.0 / pb["Ls"], dtype=torch.float32, device=device)
    out = {}
    for alpha in alphas:
        al = torch.full((n,), alpha, device=device)
        fstar = float(flix_objective(flix_optimum(A, b, mu, al, x_loc, steps=flix_steps),
                                     A, b, mu, al, x_loc))
        u = torch.rand((rounds,), generator=gen).to(device)
        t0 = wall_s()
        _, (tr, comms) = scafflix_run(
            scafflix_init(torch.ones(d, device=device), n, x_loc),
            lambda xt: logreg_grads(xt, A, b, mu), p, gammas, al, rounds,
            lambda s: flix_objective(s.x.mean(0), A, b, mu, al, x_loc), u=u)
        trace, comms = tr.double().cpu().numpy(), comms.cpu().numpy()
        out[alpha] = dict(trace=trace, comms=comms, fstar=fstar,
                          seconds=wall_s() - t0)
        log(f"  alpha={alpha}: gap after {rounds} rounds ({int(comms.sum())} comms) "
            f"= {trace[-1] - fstar:.2e}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--efbv-rounds", type=int, default=800)
    ap.add_argument("--scafflix-rounds", type=int, default=400)
    ap.add_argument("--flix-steps", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pb = problem(device)
    print(f"== Ch.2: EF-BV family, rand-k(10%), {args.efbv_rounds} rounds, on {device} ==")
    efbv = efbv_runs(pb, device, args.efbv_rounds, seed=args.seed)
    print("== Ch.3: Scafflix double acceleration (p=0.2) ==")
    sfx = scafflix_runs(pb, device, args.scafflix_rounds, seed=args.seed + 1,
                        flix_steps=args.flix_steps)
    print("(smaller alpha = more personalization = faster, matching Fig 3.1)")
    return {"efbv": efbv, "scafflix": sfx}


if __name__ == "__main__":
    main()
