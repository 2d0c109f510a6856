"""The one generator of every traffic mix, read from
``perf_bench/traffic/<name>.json``.

Sizes do not depend on the seed: a mix's prompt and output lengths are the
stratified quantiles of its distributions, and its users a stratified Zipf
draw, the same multiset for every seed.  The seed permutes them and draws
the token ids, so runs with different seeds do the same amount of work in
another order.

kind "train": ``seq_len``, ``global_batch``; each step's rows are fresh
token ids.
kind "closed": ``clients`` closed-loop clients (each sends its next
request when its last completes); ``users`` and ``user_dist`` ("zipf"
with ``zipf_s``; "uniform": each user equally often; "per_client":
client c is user c); ``prompt`` and ``output``: lognormal ``median``,
``sigma``, clipped to [``min``, ``max``]; ``requests`` specs in all, more
than a window completes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

from perf_bench.harness.weights import fold, generator


def train_batch(seed: int, step: int, traffic: dict, vocab: int, device):
    """Step ``step``'s batch: {"tokens", "targets"} (B, S) int64."""
    import torch
    B, S = traffic["global_batch"], traffic["seq_len"]
    ids = torch.randint(0, vocab, (B, S + 1), generator=generator(device, seed, "batch", step),
                        device=device)
    return {"tokens": ids[:, :-1].contiguous(), "targets": ids[:, 1:].contiguous()}


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """n stratified quantiles of lognormal(median, sigma), clipped, rounded."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def zipf_counts(users: int, s: float, n: int) -> np.ndarray:
    """n user ids with counts proportional to 1 / rank^s (largest remainder)."""
    p = 1.0 / np.arange(1, users + 1) ** s
    p /= p.sum()
    raw = p * n
    cnt = np.floor(raw).astype(np.int64)
    for i in np.argsort(-(raw - cnt))[: n - cnt.sum()]:
        cnt[i] += 1
    return np.repeat(np.arange(users), cnt)


@dataclass
class Spec:
    rid: int
    client: int
    user: int
    prompt_len: int
    out_len: int


class ClosedLoop:
    """Each client's queue of request specs and their prompts."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.t, self.seed, self.vocab = traffic, int(seed), int(vocab)
        n, C = traffic["requests"], traffic["clients"]
        rng = np.random.default_rng(fold(seed, "traffic") % (1 << 63))
        plen = rng.permutation(lognormal_lengths(traffic["prompt"], n))
        olen = rng.permutation(lognormal_lengths(traffic["output"], n))
        if traffic["user_dist"] == "zipf":
            users = rng.permutation(zipf_counts(traffic["users"], traffic["zipf_s"], n))
        elif traffic["user_dist"] == "uniform":
            users = rng.permutation(np.arange(n) % traffic["users"])
        elif traffic["user_dist"] == "per_client":
            users = np.arange(n) % C
        else:
            raise ValueError(traffic["user_dist"])
        self.queues: List[List[Spec]] = [[] for _ in range(C)]
        for i in range(n):
            c = i % C
            self.queues[c].append(Spec(i, c, int(users[i]), int(plen[i]), int(olen[i])))
        self._next = [0] * C

    def next(self, client: int) -> Spec:
        q = self.queues[client]
        s = q[self._next[client] % len(q)]
        self._next[client] += 1
        return s

    def prompt(self, spec: Spec) -> np.ndarray:
        rng = np.random.default_rng(fold(self.seed, "prompt", spec.rid) % (1 << 63))
        return rng.integers(0, self.vocab, spec.prompt_len, dtype=np.int64)
