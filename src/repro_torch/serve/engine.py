"""Batched multi-user forward: per-slot delta application (port of
``repro/serve/engine.py``).

Slot ``b``'s effective parameters are

    params_b = debucketize(base_blocks + pool_blocks[table_b])   # the user's tree

The JAX package vmaps over slots inside one jit; the port runs a per-slot
loop.  The delta path (``prefill``/``decode``) and the materialized path
(``prefill_materialized``/``decode_materialized``, fed fully materialized
per-slot f32 blocks) run the same ``_slot_*`` code on the same shapes, which
is what lets serving a user's compressed delta be certified bitwise against
serving their materialized params.

The engine's cache is a list of per-slot model caches.

Every slot call writes ONE parameter tree that the engine owns (bf16 and f32
leaves as the layout records them), in place: prefill and decode, delta and
materialized path read the same tree at the same addresses.  On the delta
path one call writes it, ``kernels.delta_apply.delta_apply``: on a CUDA
device kernel D1 reads base and the pool's rows once and stores each leaf in
its dtype, with no f32 ``eff``; on the CPU the plain version (a gather into
a transient f32 ``eff``, the add, a cast per leaf).  On the card D1's work
list is built with the tree, once, and raises on a layout D1 does not take.
The materialized path casts its given blocks with ``debucketize(..., out=)``:
the independent side of the bitwise certification.

Where every layer is a Mamba mixer and no layer routes experts, on a CUDA
device, each slot's decode step is a CUDA graph (:class:`SlotGraph`),
captured at the slot's first decode call and replayed at every later one;
everything else runs eagerly (attention's decode indexes its ring by a
Python position, MoE routing has data-dependent shapes).  Counters
``serve/graph/captures``, ``serve/graph/replays`` and ``serve/graph/eager``
(the decode calls that ran eagerly) count the slot decode calls.

Each slot call is traced (``obs.trace``): ``serve/slot/eff`` (the delta
path's apply: D1's one launch on the card), ``serve/slot/debucketize`` (the
materialized path's cast) and ``serve/slot/prefill`` or
``serve/slot/decode`` (the model's call, around a graph's capture or
replay; no span opens inside a captured region).

:class:`PersonalizedBatcher` plugs the engine into the continuous batcher:
admission pins the user's delta in the pool (paging it in on a miss) and
retirement releases the pin.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.comm.buckets import bucketize, debucketize, empty_tree
from repro_torch.configs.base import MAMBA
from repro_torch.kernels.delta_apply import delta_apply, work_list
from repro_torch.models import decode_step, prefill as model_prefill
from repro_torch.models.transformer import period_info
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.deltas import DeltaStore
from repro_torch.serve.pool import BlockPool
from repro_torch.training.serving import ContinuousBatcher, Request
from repro_torch.utils.tree import tree_leaves, tree_map


def decode_graph_eligible(cfg, device) -> bool:
    """Whether a slot's decode step is replayed as a CUDA graph: on a CUDA
    device, with every layer a Mamba mixer and no layer routing experts."""
    _, _, kinds, moe = period_info(cfg)
    return (torch.device(device).type == "cuda" and all(k == MAMBA for k in kinds)
            and not any(moe))


class SlotGraph:
    """One slot's ``decode_step`` captured as a CUDA graph.

    The graph reads the engine's parameter tree, its own token buffer and
    its own decode cache at the addresses it was captured against, and
    writes its own logits.  ``step`` first copies a cache it did not hand
    out (a prefill's) into its buffers; the cache it returns is its own,
    valid until the slot's next decode call.  ``pos`` is a Python int,
    advanced here after each replay."""

    def __init__(self, cfg, params, tok_b: torch.Tensor, cache_b: dict, pool):
        self.tok = tok_b.clone()
        self.cache = {"layers": tree_map(torch.clone, cache_b["layers"]), "pos": 0}
        # warm up off the capture (lazy initialization: cuBLAS handles,
        # workspaces); the step it takes is undone by ``step``'s load
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            decode_step(params, cfg, self.tok[None], self.cache)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.logits, _ = decode_step(params, cfg, self.tok[None], self.cache)

    def step(self, tok_b: torch.Tensor, cache_b: dict):
        if cache_b is not self.cache:
            for dst, src in zip(tree_leaves(self.cache["layers"]),
                                tree_leaves(cache_b["layers"])):
                dst.copy_(src)
            self.cache["pos"] = cache_b["pos"]
        self.tok.copy_(tok_b)
        self.graph.replay()
        self.cache["pos"] += 1
        return self.logits, self.cache


class DeltaServeEngine:
    """Prefill/decode where each batch slot applies its own delta.  Serves
    every decoder-only config (dense, MoE, Mamba, hybrid); refuses
    encoder-decoder and vision configs, as the reference does."""

    def __init__(self, cfg, store: DeltaStore, max_len: int = 128, metrics=None):
        if cfg.enc_layers or cfg.vision_tokens:
            raise NotImplementedError(
                "DeltaServeEngine serves decoder-only configs")
        self.cfg = cfg
        self.store = store
        self.layout = store.layout
        self.max_len = int(max_len)
        if metrics is None:
            from repro_torch.obs.metrics import registry as metrics
        self.metrics = metrics
        self.graphed = decode_graph_eligible(cfg, store.device)
        # the one parameter tree (and, on the card, D1's work list over it),
        # made at the first slot call: not held through the set-up's
        # page-ins, whose transients it would add to
        self._params = None
        self._work = None
        self._graphs = {}           # (path, slot) -> SlotGraph
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

    # -- one slot (shared by both paths) ------------------------------------
    def _tree(self):
        if self._params is None:
            self._params = empty_tree(self.layout, self.store.device)
            if self.store.device.type == "cuda":
                self._work = work_list(self.layout, self._params)
        return self._params

    def _apply_delta(self, pool: BlockPool, table: torch.Tensor):
        """Delta path: ``base + pool[table]`` into the engine's tree, in
        place: D1 on the card, the plain version on the CPU."""
        tree = self._tree()
        with obs_trace.span("serve/slot/eff"):
            return delta_apply(self.store.base_blocks, pool.blocks, table, tree, self.layout,
                               self._work)

    def _load_params(self, eff_b: torch.Tensor):
        """Materialized path: ``eff_b`` cast into the engine's tree, in place."""
        tree = self._tree()
        with obs_trace.span("serve/slot/debucketize"):
            return debucketize(eff_b, self.layout, out=tree)

    def _slot_prefill(self, params, tokens_b: torch.Tensor):
        with obs_trace.span("serve/slot/prefill"):
            logits, cache = model_prefill(params, self.cfg, {"tokens": tokens_b[None]},
                                          cache_len=self.max_len)
        return logits[0], cache

    def _slot_decode(self, params, tok_b: torch.Tensor, cache_b: dict, key: tuple):
        with obs_trace.span("serve/slot/decode"):
            logits, cache = self._decode(params, tok_b, cache_b, key)
        return logits[0], cache

    def _decode(self, params, tok_b: torch.Tensor, cache_b: dict, key: tuple):
        """The model's decode step of one slot: eager, or the CUDA graph of
        ``key`` (path, slot), captured at its first call."""
        if not self.graphed:
            self.metrics.counter("serve/graph/eager").inc()
            return decode_step(params, self.cfg, tok_b[None], cache_b)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = SlotGraph(self.cfg, params, tok_b, cache_b,
                                                  self._pool)
            self.metrics.counter("serve/graph/captures").inc()
        else:
            self.metrics.counter("serve/graph/replays").inc()
        return graph.step(tok_b, cache_b)

    def _run(self, one, params_of, n: int, *per_slot):
        outs = [one(params_of(b), *(a[b] for a in per_slot)) for b in range(n)]
        return torch.stack([o[0] for o in outs]), [o[1] for o in outs]

    def _tables(self, tables) -> torch.Tensor:
        return torch.as_tensor(tables, dtype=torch.int32, device=self.store.device)

    # -- delta path (production) ---------------------------------------------
    def prefill(self, pool: BlockPool, tables, tokens: torch.Tensor):
        """tables (B, n_blocks) int; tokens (B, L) -> (logits (B,1,V), caches)."""
        tables = self._tables(tables)
        return self._run(self._slot_prefill, lambda b: self._apply_delta(pool, tables[b]),
                         tokens.shape[0], tokens)

    def decode(self, pool: BlockPool, tables, tok: torch.Tensor, cache: List[dict]):
        """The caches returned may be the slots' graph buffers: each is valid
        until that slot's next decode call on this path."""
        tables = self._tables(tables)
        n = tok.shape[0]
        return self._run(self._slot_decode, lambda b: self._apply_delta(pool, tables[b]),
                         n, tok, cache, [("delta", b) for b in range(n)])

    # -- materialized path (oracle / full-copy serving) ----------------------
    def prefill_materialized(self, eff_blocks: Sequence[torch.Tensor], tokens: torch.Tensor):
        """``eff_blocks[b]`` is slot b's (n_blocks, bs) f32 blocks."""
        return self._run(self._slot_prefill, lambda b: self._load_params(eff_blocks[b]),
                         tokens.shape[0], tokens)

    def decode_materialized(self, eff_blocks: Sequence[torch.Tensor], tok: torch.Tensor,
                            cache: List[dict]):
        n = tok.shape[0]
        return self._run(self._slot_decode, lambda b: self._load_params(eff_blocks[b]),
                         n, tok, cache, [("materialized", b) for b in range(n)])

    def eff_blocks_for(self, params_list: List) -> torch.Tensor:
        """Per-slot materialized trees -> (B, n_blocks, bs) blocks."""
        out = []
        for p in params_list:
            blocks, layout = bucketize(p, self.layout.bucket_size)
            if layout.shapes != self.layout.shapes:
                raise ValueError("materialized tree does not match store layout")
            out.append(blocks)
        return torch.stack(out)


class PersonalizedBatcher(ContinuousBatcher):
    """Continuous batcher whose slots each serve their own personalized user.

    Admission ``acquire``s the request's ``user_id`` from the block pool
    (page-in on a miss, pinned while scheduled); retirement releases the pin
    and zeroes the slot's block table.  ``user_id=None`` serves the bare base
    model (all-zero table, nothing pinned).
    """

    def __init__(self, cfg, store: DeltaStore, pool: BlockPool,
                 n_slots: int = 4, max_len: int = 128):
        self.store = store
        self.pool = pool
        self._tables = torch.zeros((n_slots, store.layout.n_buckets),
                                   dtype=torch.int32, device=store.device)
        super().__init__(cfg, params=None, n_slots=n_slots, max_len=max_len,
                         device=store.device)

    def _build_model(self) -> None:
        self.engine = DeltaServeEngine(self.cfg, self.store, self.max_len,
                                       metrics=self.pool.metrics)

    def _model_prefill(self, batch):
        return self.engine.prefill(self.pool, self._tables, batch["tokens"])

    def _model_decode(self, tok):
        return self.engine.decode(self.pool, self._tables, tok, self.cache)

    def _on_admit(self, slot: int, req: Request) -> None:
        if req.user_id is None:
            self._tables[slot] = 0
            return
        self._tables[slot] = self.pool.acquire(req.user_id).table

    def _on_retire(self, slot: int, req: Request) -> None:
        self._tables[slot] = 0
        if req.user_id is not None:
            self.pool.release(req.user_id)
