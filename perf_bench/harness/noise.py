"""The quantizer's uniform draws, made by the benchmark from the seed.

``RowNoise`` stands for a (rows, 512) f32 tensor of draws in [0, 1) without
holding it: rows are made on demand, block by block, each block of
``BLOCK_ROWS`` rows from its own generator seeded with (seed, purpose,
block).  Any slice of rows therefore reads the same values, whoever asks
and in whatever chunks.  The program takes it as the ``noise`` of its
EF-BV sync (it slices rows and reads ``shape``); the reference reads the
same rows through ``rows``.
"""
from __future__ import annotations

import torch

from perf_bench.harness.weights import generator

QBLOCK = 512
BLOCK_ROWS = 1 << 16


def tile_rows(d: int) -> int:
    """Rows of 512 elements a d-element vector takes, padded to whole tiles
    of 8 rows: the quantizer's draw is (tile_rows(d), 512)."""
    return -(-d // 4096) * 8


class RowNoise:
    def __init__(self, device, n_rows: int, *seed_parts):
        self.device = torch.device(device)
        self.n_rows = int(n_rows)
        self.seed_parts = seed_parts

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n_rows, QBLOCK))

    def _block(self, b: int) -> torch.Tensor:
        n = min(BLOCK_ROWS, self.n_rows - b * BLOCK_ROWS)
        return torch.rand((n, QBLOCK), generator=generator(self.device, *self.seed_parts, b),
                          dtype=torch.float32, device=self.device)

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        """Rows r0..r1 (r1 may pass the end: those rows read as 0.5)."""
        out = torch.full((r1 - r0, QBLOCK), 0.5, dtype=torch.float32, device=self.device)
        stop = min(r1, self.n_rows)
        b = r0 // BLOCK_ROWS
        while b * BLOCK_ROWS < stop:
            lo = max(r0, b * BLOCK_ROWS)
            hi = min(stop, (b + 1) * BLOCK_ROWS)
            out[lo - r0: hi - r0] = self._block(b)[lo - b * BLOCK_ROWS: hi - b * BLOCK_ROWS]
            b += 1
        return out

    def __getitem__(self, sl: slice) -> torch.Tensor:
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("RowNoise takes a slice of rows")
        r0, r1, _ = sl.indices(self.n_rows)
        return self.rows(r0, r1)

    def materialize(self) -> torch.Tensor:
        return self.rows(0, self.n_rows)
