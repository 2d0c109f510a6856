"""Federated data substrate: non-IID client splits + convex logreg problems.

(The port's copy of ``repro/data/federated.py``: numpy only, as the
reference is, so both packages build the same clients, bit for bit, from the
same seed.  It is host code: the problems it builds are moved to the card by
their callers.)

The dissertation's convex experiments (Ch. 2, 3, 5) run l2-regularized logistic
regression on LibSVM datasets split feature-wise / class-wise / Dirichlet
non-IID across clients.  LibSVM is unavailable offline, so we generate
controlled synthetic classification data with the same knobs (client
heterogeneity, conditioning) — heterogeneity is what the theory cares about
(mu_i, L_i spread, gradient diversity at the optimum), and we control it
exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.faults.model import counter_normal, counter_uniform


def dirichlet_mixtures(client_ids, n_classes: int, alpha: float,
                       seed: int = 0) -> np.ndarray:
    """Per-client Dirichlet(alpha) class mixtures at population scale.

    ``dirichlet_split`` materializes index lists — fine for tens of clients,
    impossible for 10^6.  This is the population-scale form the cohort
    simulator uses: row ``i`` is client ``client_ids[i]``'s class-probability
    vector, drawn from the counter PRNG addressed by ``(seed, class,
    client_id)`` — a pure function of the client id, so deriving a sampled
    cohort's mixtures equals slicing the full population's (lane-sliceable,
    like every ``faults.model`` process).

    Gamma draws use the Wilson-Hilferty cube at shape ``alpha + 1`` with the
    exact boost ``Gamma(alpha) = Gamma(alpha+1) * U^(1/alpha)``, normalized
    per client in log space so alpha -> 0 concentrates each client on a
    single class without underflow and alpha -> inf approaches the uniform
    (IID) mixture.

    ``client_ids`` is an ``(n,)`` int array of population ids, or an int n
    (meaning ids ``0..n-1``).
    """
    if np.ndim(client_ids) == 0:
        client_ids = np.arange(int(client_ids))
    ids = np.asarray(client_ids, np.int64)
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    a = float(alpha)
    k = a + 1.0
    n = ids.shape[0]
    log_g = np.empty((n, int(n_classes)))
    for c in range(int(n_classes)):
        z = counter_normal(seed, 0, f"dirichlet/{c}", n, lane=ids)
        u = counter_uniform(seed, 0, f"dirichlet/{c}/boost", n, lane=ids)
        # Wilson-Hilferty: Gamma(k) ~= k * (1 - 1/(9k) + z*sqrt(1/(9k)))^3
        wh = k * np.maximum(1.0 - 1.0 / (9.0 * k)
                            + z * np.sqrt(1.0 / (9.0 * k)), 0.0) ** 3
        log_g[:, c] = (np.log(np.maximum(wh, 1e-300))
                       + np.log(np.maximum(u, 1e-300)) / a)
    log_g -= log_g.max(axis=1, keepdims=True)
    mix = np.exp(log_g)
    mix /= mix.sum(axis=1, keepdims=True)
    return mix


def dirichlet_split(labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0) -> List[np.ndarray]:
    """Dirichlet(alpha) label-skew split (the paper's S2). Returns index lists."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_clients))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in client_idx]


def classwise_split(labels: np.ndarray, n_clients: int, classes_per_client: int = 2, seed: int = 0) -> List[np.ndarray]:
    """Class-wise non-IID split (the paper's S1): each client sees few classes."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    assign = [rng.choice(classes, size=classes_per_client, replace=False) for _ in range(n_clients)]
    pools = {c: list(np.flatnonzero(labels == c)) for c in classes}
    for c in pools:
        rng.shuffle(pools[c])
    # counts is positional: index by the class's position in `classes`, not by
    # the raw label value (non-contiguous label sets like {1, 3, 7} would
    # crash or silently credit the wrong class)
    pos = {c: i for i, c in enumerate(classes)}
    counts = np.zeros(len(classes), dtype=int)
    for a in assign:
        for c in a:
            counts[pos[c]] += 1
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for i, a in enumerate(assign):
        for c in a:
            pool = pools[c]
            take = max(1, len(pool) // counts[pos[c]])
            client_idx[i].extend(pool[:take])
            pools[c] = pool[take:]
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in client_idx]


@dataclass
class FederatedLogReg:
    """n_clients l2-regularized logistic-regression objectives.

    f_i(x) = 1/n_i sum_j log(1+exp(-b_ij a_ij^T x)) + mu/2 ||x||^2
    Heterogeneity: each client's features are drawn around a client-specific
    mean direction scaled by ``hetero`` (0 => IID).
    """
    A: np.ndarray          # (n_clients, m, d)
    b: np.ndarray          # (n_clients, m) in {-1, +1}
    mu: float

    @property
    def n_clients(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[2]

    def smoothness(self) -> np.ndarray:
        """Per-client L_i = ||A_i||_row^2 / (4 m) + mu (paper Ch.3 formula)."""
        m = self.A.shape[1]
        return (np.sum(self.A**2, axis=(1, 2)) / (4 * m)) + self.mu


def make_logreg_clients(
    n_clients: int = 10,
    m: int = 200,
    d: int = 40,
    mu: float = 0.1,
    hetero: float = 1.0,
    seed: int = 0,
) -> FederatedLogReg:
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_clients, m, d))
    # client-specific shift + scale => heterogeneous mu_i/L_i and non-IID data
    shift = rng.normal(size=(n_clients, 1, d)) * hetero
    scale = 1.0 + hetero * rng.random((n_clients, 1, 1))
    A = (A + shift) * scale
    x_true = rng.normal(size=d)
    w_true = x_true + hetero * rng.normal(size=(n_clients, d))  # per-client label rule
    logits = np.einsum("nmd,nd->nm", A, w_true)
    p = 1 / (1 + np.exp(-logits))
    b = np.where(rng.random((n_clients, m)) < p, 1.0, -1.0)
    return FederatedLogReg(A=A.astype(np.float64), b=b.astype(np.float64), mu=mu)
