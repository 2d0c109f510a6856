"""FedP3: federated personalized privacy-friendly pruning (Ch. 4, Alg. 5-7);
port of ``repro/core/fedp3.py``.

Mechanisms:
  * server->client global pruning P_i: per-client random diagonal mask on the
    non-trained layers (Definition 4.3.1 sketch), ratio r (r=0.9 keeps 90%)
  * layer-subset training L_i (OPU-k): each client trains k uniformly chosen
    layers + the final classifier (FFC), uploading ONLY those layers
  * local pruning Q_i strategies (Alg. 6): fixed | uniform | ordered_dropout
  * aggregation (Alg. 7): simple | weighted averaging over the clients that
    trained each layer
  * LDP-FedP3 hook: Gaussian noise of scale sigma added to uploads

The model is a configurable MLP (the paper's EMNIST-L architecture family);
communication cost is counted in uploaded floats exactly as Figs. 4.2/4.4.

Randomness.  The client and layer choices come from numpy's
``default_rng(cfg.seed)`` in the reference's order, so they are identical.
Every draw the reference takes from a JAX key (the normal init, the
uniform global masks, the uniform / randint local prune factor, the LDP
noise) comes from a draw source passed in, in the reference's call order:
``TorchDraws`` (an explicit ``torch.Generator``) by default, or the JAX
package's recorded draws replayed, as the tests do.  Gradients are
``torch.autograd.grad`` of the same cross-entropy.  Plain torch, as the
reference is plain jnp: it reaches no kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.utils.device import make_generator, resolve_device


class TorchDraws:
    """The draws of ``fedp3_train`` from one explicit ``torch.Generator``
    (on the generator's device).  A draw source has these three methods; each
    returns f32 (``randint``: int64) values on ``device``."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def normal(self, shape, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.g.device).to(device)

    def uniform(self, shape, device, minval: float = 0.0, maxval: float = 1.0):
        u = torch.rand(shape, generator=self.g, device=self.g.device).to(device)
        return u * (maxval - minval) + minval

    def randint(self, shape, device, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, shape, generator=self.g,
                             device=self.g.device).to(device)


# ---------------------------------------------------------------------------
# MLP model (list of dense layers); layer l params = (W_l, b_l)
# ---------------------------------------------------------------------------
def init_mlp_params(draws, sizes: Sequence[int], device) -> List[dict]:
    return [{"W": draws.normal((sizes[i], sizes[i + 1]), device) / math.sqrt(sizes[i]),
             "b": torch.zeros((sizes[i + 1],), device=device)}
            for i in range(len(sizes) - 1)]


def mlp_apply(layers: List[dict], x: torch.Tensor) -> torch.Tensor:
    for i, l in enumerate(layers):
        x = x @ l["W"] + l["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def xent(layers, x, y, nclass):
    logp = torch.log_softmax(mlp_apply(layers, x), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def layer_sizes(layers: List[dict]) -> List[int]:
    return [int(l["W"].numel() + l["b"].numel()) for l in layers]


# ---------------------------------------------------------------------------
# Pruning operators
# ---------------------------------------------------------------------------
def global_prune_mask(draws, layers: List[dict], ratio: float) -> List[dict]:
    """P_i: keep each weight w.p. ``ratio`` (biased diagonal sketch, Def 4.3.1)."""
    return [{"W": (draws.uniform(tuple(l["W"].shape), l["W"].device) < ratio).to(l["W"].dtype),
             "b": torch.ones_like(l["b"])} for l in layers]


def local_prune_factor(draws, strategy: str, base_ratio: float, device) -> torch.Tensor:
    """q_{i,k} per local step (Alg. 6 line 2)."""
    if strategy == "fixed":
        return torch.ones((), device=device)
    if strategy == "uniform":
        return draws.uniform((), device, minval=base_ratio, maxval=1.0)
    if strategy == "ordered_dropout":
        # FjORD-style: a discrete width multiplier
        opts = torch.tensor([base_ratio, (base_ratio + 1) / 2, 1.0], device=device)
        return opts[draws.randint((), device, 0, 3)]
    raise ValueError(strategy)


def apply_ordered_dropout(l: dict, q: torch.Tensor) -> dict:
    """Keep the first q-fraction rows/cols (Horvath et al. ordered dropout)."""
    W = l["W"]
    d1, d2 = W.shape
    rows = torch.arange(d1, device=W.device)[:, None] < q * d1
    cols = torch.arange(d2, device=W.device)[None, :] < q * d2
    return {"W": W * (rows & cols).to(W.dtype), "b": l["b"]}


# ---------------------------------------------------------------------------
# FedP3 round
# ---------------------------------------------------------------------------
@dataclass
class FedP3Config:
    n_clients: int = 20
    clients_per_round: int = 10
    layers_per_client: int = 3      # OPU-k (k trained layers incl. FFC)
    global_prune_ratio: float = 0.9
    local_strategy: str = "fixed"   # fixed | uniform | ordered_dropout
    local_steps: int = 4
    lr: float = 0.1
    aggregation: str = "simple"     # simple | weighted
    ldp_sigma: float = 0.0
    seed: int = 0


def fedp3_train(cfg: FedP3Config, Xs: List[np.ndarray], Ys: List[np.ndarray],
                sizes: Sequence[int], rounds: int, X_test, Y_test, draws=None,
                device=None):
    """Returns (accuracy trace, uploaded-floats trace, final params).

    ``draws``: the draw source (default ``TorchDraws`` seeded from
    ``cfg.seed`` on ``device``).  The accuracies stay on the device until
    the end."""
    device = resolve_device(device)
    if draws is None:
        draws = TorchDraws(make_generator(cfg.seed, device))
    nclass = sizes[-1]
    rng = np.random.default_rng(cfg.seed)
    global_params = init_mlp_params(draws, sizes, device)
    L = len(global_params)
    ffc = L - 1  # everyone trains the final classifier

    Xs = [torch.as_tensor(x, device=device) for x in Xs]
    Ys = [torch.as_tensor(y, device=device).long() for y in Ys]
    X_test = torch.as_tensor(X_test, device=device)
    Y_test = torch.as_tensor(Y_test, device=device).long()
    acc_trace = torch.zeros((rounds,), device=device)
    bytes_trace = []
    total_upload = 0.0

    for t in range(rounds):
        chosen = rng.choice(cfg.n_clients, size=cfg.clients_per_round, replace=False)
        uploads: Dict[int, list] = {l: [] for l in range(L)}
        upload_weights: Dict[int, list] = {l: [] for l in range(L)}

        for i in chosen:
            # layer subset L_i: (layers_per_client-1) random hidden + FFC
            n_extra = min(cfg.layers_per_client - 1, L - 1)
            extra = rng.choice(L - 1, size=n_extra, replace=False) if n_extra else []
            L_i = sorted(set(list(extra) + [ffc]))
            # global pruning on the frozen layers
            masks = global_prune_mask(draws, global_params, cfg.global_prune_ratio)
            params = [dict(l) if l_idx in L_i else
                      {"W": l["W"] * masks[l_idx]["W"], "b": l["b"]}
                      for l_idx, l in enumerate(global_params)]
            # local training (only L_i layers step)
            for _ in range(cfg.local_steps):
                q = local_prune_factor(draws, cfg.local_strategy, cfg.global_prune_ratio,
                                       device)
                trained = [params[l_idx][k].detach().requires_grad_()
                           for l_idx in L_i for k in ("W", "b")]
                for j, l_idx in enumerate(L_i):
                    params[l_idx] = {"W": trained[2 * j], "b": trained[2 * j + 1]}
                eff = [apply_ordered_dropout(p, q)
                       if (cfg.local_strategy == "ordered_dropout" and l_idx not in L_i)
                       else p
                       for l_idx, p in enumerate(params)]
                g = torch.autograd.grad(xent(eff, Xs[i], Ys[i], nclass), trained)
                with torch.no_grad():
                    for j, l_idx in enumerate(L_i):
                        params[l_idx] = {"W": trained[2 * j] - cfg.lr * g[2 * j],
                                         "b": trained[2 * j + 1] - cfg.lr * g[2 * j + 1]}
            # upload only L_i (+ optional LDP noise)
            for l_idx in L_i:
                up = params[l_idx]
                if cfg.ldp_sigma > 0:
                    up = {"W": up["W"] + cfg.ldp_sigma * draws.normal(tuple(up["W"].shape),
                                                                      device),
                          "b": up["b"]}
                uploads[l_idx].append(up)
                upload_weights[l_idx].append(len(L_i))
                total_upload += up["W"].numel() + up["b"].numel()

        # aggregation (Alg. 7)
        new_params = []
        for l_idx, l in enumerate(global_params):
            ups = uploads[l_idx]
            if not ups:
                new_params.append(l)
                continue
            if cfg.aggregation == "weighted":
                w = np.asarray(upload_weights[l_idx], dtype=np.float64)
                w = w / w.sum()
            else:
                w = np.full(len(ups), 1.0 / len(ups))
            new_params.append({"W": sum(float(wi) * u["W"] for wi, u in zip(w, ups)),
                               "b": sum(float(wi) * u["b"] for wi, u in zip(w, ups))})
        global_params = new_params

        with torch.no_grad():
            logits = mlp_apply(global_params, X_test)
            acc_trace[t] = (logits.argmax(1) == Y_test).float().mean()
        bytes_trace.append(total_upload)
    acc = acc_trace.double().cpu().numpy()
    return acc, np.asarray(bytes_trace), global_params


def make_classification(n: int = 2000, d: int = 32, nclass: int = 10, seed: int = 0,
                        means_seed: int = 1234, sep: float = 2.0,
                        label_noise: float = 0.0):
    """Synthetic multi-class data with class-dependent Gaussian means (numpy,
    the reference's copy: the same seeds give the same data).

    ``means_seed`` fixes the class geometry so train/test splits drawn with
    different ``seed`` values share the same distribution; ``sep`` scales the
    class separation and ``label_noise`` flips a fraction of labels."""
    means = np.random.default_rng(means_seed).normal(size=(nclass, d)) * sep
    rng = np.random.default_rng(seed)
    y = rng.integers(0, nclass, size=n)
    X = means[y] + rng.normal(size=(n, d))
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        y = np.where(flip, rng.integers(0, nclass, size=n), y)
    return X.astype(np.float32), y.astype(np.int32)
