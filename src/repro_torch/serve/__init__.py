"""repro_torch.serve — the personalized-model serving plane.

  deltas   DeltaStore: base blocks + certified per-user delta payloads
  pool     BlockPool: device pool of decoded delta blocks, LRU + pins
  engine   DeltaServeEngine (per-slot delta gather + apply) and
           PersonalizedBatcher (the engine inside the continuous batcher)
"""
from repro_torch.serve.deltas import (DEFAULT_BLOCK, DeltaCertificationError,
                                      DeltaStore, delta_blocks,
                                      delta_from_params, params_from_delta,
                                      personalize_leaves, user_seed)
from repro_torch.serve.engine import DeltaServeEngine, PersonalizedBatcher
from repro_torch.serve.pool import BlockPool, PoolEntry, PoolExhausted, ZERO_ROW
