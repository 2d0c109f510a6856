"""Fixed-capacity device pool of decoded delta blocks (port of
``repro/serve/pool.py``).

An entry is one user's set of *nonzero* decoded delta blocks; zero blocks all
alias the reserved all-zero row 0, so a user's resident cost is O(nonzero
delta blocks), not O(model blocks).

  * miss  — decode the stored payload on the device (kernel B3 for a
            ``qsgd_kernel`` payload), copy the nonzero blocks into free pool
            rows, charge exactly ``payload.nbytes`` under ``serve/page_in``;
  * hit   — already resident: no decode, no bytes;
  * evict — pages are clean (the payload is the durable copy), so eviction
            only frees rows.

Entries are LRU-ordered; ``acquire`` pins an entry for a batch slot's
lifetime and pinned entries are never evicted (``release`` unpins).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.comm.ledger import PAGE_IN_TAG
from repro_torch.serve.deltas import DeltaStore

ZERO_ROW = 0  # reserved pool row: the shared all-zero delta block
PAGE_IN_LINK = "store->pool"  # ledger link name of a page-in


class PoolExhausted(RuntimeError):
    """Not enough unpinned rows to page a user in."""


@dataclass
class PoolEntry:
    """One resident user: which pool rows hold their nonzero blocks."""
    user_id: int
    rows: np.ndarray            # pool rows backing the nonzero blocks
    table: torch.Tensor         # (n_model_blocks,) int32 on the device -> pool row
    payload_nbytes: int
    pins: int = 0

    @property
    def n_blocks(self) -> int:
        return int(len(self.rows))


class BlockPool:
    """LRU pager over a ``(capacity+1, block_size)`` device block array."""

    def __init__(self, store: DeltaStore, capacity_blocks: int, metrics=None):
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.store = store
        self.capacity = int(capacity_blocks)
        bs = store.layout.bucket_size
        # row 0 is the shared zero block; it is never allocated or written
        self.blocks = torch.zeros((self.capacity + 1, bs), dtype=torch.float32,
                                  device=store.device)
        self._free: List[int] = list(range(self.capacity, 0, -1))
        self._entries: "OrderedDict[int, PoolEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_paged_in = 0
        self._events = 0
        if metrics is None:
            from repro_torch.obs.metrics import registry as metrics
        self.metrics = metrics

    @property
    def resident_blocks(self) -> int:
        return self.capacity - len(self._free)

    @property
    def resident_bytes(self) -> int:
        return self.resident_blocks * self.store.layout.bucket_size * 4

    @property
    def device_bytes(self) -> int:
        return int(self.blocks.numel()) * 4

    def is_resident(self, uid: int) -> bool:
        return int(uid) in self._entries

    def entry(self, uid: int) -> PoolEntry:
        return self._entries[int(uid)]

    def table_for(self, uid: int) -> torch.Tensor:
        return self._entries[int(uid)].table

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_paged_in": self.bytes_paged_in,
                "resident_blocks": self.resident_blocks,
                "resident_users": len(self._entries),
                "pinned_users": sum(1 for e in self._entries.values() if e.pins > 0)}

    def acquire(self, uid: int) -> PoolEntry:
        """Pin user ``uid`` resident, paging them in on a miss."""
        uid = int(uid)
        entry = self._entries.get(uid)
        if entry is not None:
            self._entries.move_to_end(uid)
            entry.pins += 1
            self.hits += 1
            self.metrics.counter("serve/pool/hits").inc()
            self._note_residency()
            return entry
        return self._page_in(uid)

    def release(self, uid: int) -> None:
        """Unpin (the entry stays resident until LRU-evicted)."""
        entry = self._entries[int(uid)]
        if entry.pins <= 0:
            raise RuntimeError(f"release() without matching acquire() for user {uid}")
        entry.pins -= 1
        self._note_residency()

    def _page_in(self, uid: int) -> PoolEntry:
        payload = self.store.payload(uid)
        carrier = self.store.blocks(uid)                       # device decode
        nz = torch.nonzero(carrier.ne(0).any(dim=1)).reshape(-1)
        rows = self._alloc(int(nz.numel()))
        table = torch.zeros(self.store.layout.n_buckets, dtype=torch.int32,
                            device=self.blocks.device)
        if len(rows):
            rows_t = torch.as_tensor(rows, dtype=torch.long, device=self.blocks.device)
            self.blocks.index_copy_(0, rows_t, carrier.index_select(0, nz))
            table[nz] = rows_t.to(torch.int32)
        del carrier
        entry = PoolEntry(uid, rows, table, payload.nbytes, pins=1)
        self._entries[uid] = entry
        self.misses += 1
        self.bytes_paged_in += payload.nbytes
        self.store.ledger.record(self._events, f"{PAGE_IN_LINK}/u{uid}",
                                 payload.nbytes, kind="intra", tag=PAGE_IN_TAG)
        self._events += 1
        self.metrics.counter("serve/pool/misses").inc()
        self.metrics.counter("serve/pool/page_in_bytes").inc(payload.nbytes)
        self._note_residency()
        return entry

    def _alloc(self, n: int) -> np.ndarray:
        if n > self.capacity:
            raise PoolExhausted(f"user needs {n} blocks; pool capacity is {self.capacity}")
        while len(self._free) < n:
            if not self._evict_one():
                raise PoolExhausted(f"need {n} free blocks, have {len(self._free)}; "
                                    f"every resident entry is pinned")
        return np.asarray([self._free.pop() for _ in range(n)], np.int32)

    def _evict_one(self) -> bool:
        for uid, entry in self._entries.items():       # oldest first
            if entry.pins == 0:
                del self._entries[uid]
                self._free.extend(int(r) for r in entry.rows)
                self.evictions += 1
                self.metrics.counter("serve/pool/evictions").inc()
                return True
        return False

    def _note_residency(self) -> None:
        self.metrics.gauge("serve/pool/resident_blocks").set(self.resident_blocks)
        self.metrics.gauge("serve/pool/resident_bytes").set(self.resident_bytes)
        self.metrics.gauge("serve/pool/resident_users").set(len(self._entries))
