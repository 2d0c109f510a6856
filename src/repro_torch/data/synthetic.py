"""Synthetic language-model corpus.

(The port's copy of ``repro/data/synthetic.py``: numpy only, so both
packages feed the same tokens for the same seed.)

Offline container => no downloads.  We generate a Zipf-distributed Markov
token stream with injected n-gram structure so a model actually has signal to
learn (loss drops well below uniform), deterministic per seed.  This feeds the
end-to-end training example and the serve examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    length: int
    seed: int = 0
    order: int = 2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse markov transition: each (prev,) state strongly prefers a few
        # successors, successors drawn zipf-ish so frequent tokens cluster.
        n_states = min(4096, v)
        branch = 8
        self._succ = rng.integers(0, v, size=(n_states, branch), dtype=np.int64)
        zipf = 1.0 / np.arange(1, branch + 1)
        self._succ_p = zipf / zipf.sum()
        self._n_states = n_states
        self._tokens = self._generate(rng)

    def _generate(self, rng) -> np.ndarray:
        out = np.empty(self.length, dtype=np.int32)
        state = 0
        noise = rng.random(self.length)
        picks = rng.integers(0, len(self._succ_p), size=self.length)
        cum = np.cumsum(self._succ_p)
        choice = np.searchsorted(cum, rng.random(self.length))
        uniform = rng.integers(0, self.vocab_size, size=self.length)
        for i in range(self.length):
            if noise[i] < 0.85:
                tok = self._succ[state, choice[i]]
            else:
                tok = uniform[i]
            out[i] = tok
            state = int(tok) % self._n_states
        return out

    @property
    def tokens(self) -> np.ndarray:
        return self._tokens


def lm_batch_iterator(
    ds: SyntheticLMDataset, batch: int, seq_len: int, seed: int = 0
) -> Iterator[dict]:
    """Yields {'tokens': (B, S+1) int32}; model shifts internally."""
    rng = np.random.default_rng(seed)
    n = len(ds.tokens) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        rows = np.stack([ds.tokens[s : s + seq_len + 1] for s in starts])
        yield {"tokens": rows.astype(np.int32)}
