"""Continuous-batching serving loop (port of ``repro/training/serving.py``).

A slot-based scheduler over prefill/decode: requests with ragged prompts
occupy fixed decode slots; finished slots are refilled from the queue
without stalling the running batch.  A refill re-prefills every live slot
together, left-padded to a common length (running requests keep their full
prompt + generated context), exactly as the JAX package does.

Subclass hooks (``repro_torch.serve.engine.PersonalizedBatcher`` uses all
four): ``_build_model``, ``_model_prefill`` / ``_model_decode``,
``_on_admit`` / ``_on_retire``.

Spans (``obs.trace``): ``serve/admit`` holds a refill's admission and its
``serve/prefill``; each decode step is ``serve/decode`` and then
``serve/token/decode``, the host's read of its tokens, which waits for the
device.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) int
    max_new: int = 32
    stop_token: Optional[int] = None
    user_id: Optional[int] = None   # personalized-delta user (None = base)
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    admitted: int = 0
    completed: int = 0
    decode_steps: int = 0
    prefills: int = 0
    tokens_out: int = 0


class ContinuousBatcher:
    """Fixed-slot continuous batching over (prefill, decode_step).

    ``device``: where the model runs; ``None`` takes the params' device (or
    the card when there are no params)."""

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 128,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        if device is None and params is not None:
            device = tree_leaves(params)[0].device
        self.device = resolve_device(device)
        self._build_model()
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.cache = None
        self.next_tok = np.zeros((n_slots, 1), np.int64)
        self.stats = ServeStats()

    # -- model hooks -----------------------------------------------------------
    def _build_model(self) -> None:
        from repro_torch.models import decode_step, prefill
        self._prefill = lambda p, b: prefill(p, self.cfg, b, cache_len=self.max_len)
        self._decode = lambda p, t, c: decode_step(p, self.cfg, t, c)

    def _model_prefill(self, batch):
        return self._prefill(self.params, batch)

    def _model_decode(self, tok):
        return self._decode(self.params, tok, self.cache)

    def _on_admit(self, slot: int, req: Request) -> None:
        """A request was just placed into ``slot`` (before its prefill)."""

    def _on_retire(self, slot: int, req: Request) -> None:
        """``req`` in ``slot`` just finished (stop token or max_new)."""

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.stats.admitted += 1

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None or r.done]

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """Argmax over the real vocab (padded rows trimmed) -> host (B,)."""
        return logits[:, -1, :self.cfg.vocab_size].argmax(-1).cpu().numpy()

    def _admit(self) -> None:
        """Fill free slots from the queue with one batched prefill of every
        live slot, left-padded to a common length."""
        free = self._free_slots()
        if not free or not self.queue:
            return
        with obs_trace.span("serve/admit") as sp:
            n_new = 0
            for i in free:
                if not self.queue:
                    break
                self.slots[i] = self.queue.popleft()
                self._on_admit(i, self.slots[i])
                n_new += 1
            live = [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and not r.done]
            sp.tag(new=n_new, live=len(live))
            if not live:
                return
            ctxs = [np.concatenate([r.prompt, np.asarray(r.generated, np.int64)])
                    for _, r in live]
            maxlen = max(len(c) for c in ctxs)
            batch_tokens = np.zeros((self.n_slots, maxlen), np.int64)
            for (i, r), c in zip(live, ctxs):
                batch_tokens[i, maxlen - len(c):] = c
            batch = {"tokens": torch.as_tensor(batch_tokens, device=self.device)}
            # the encoder's and the vision stub's inputs: zeros, as the
            # reference's batcher feeds them
            if self.cfg.enc_layers:
                batch["src_embeds"] = torch.zeros(
                    (self.n_slots, 8, self.cfg.enc_d_model or self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            if self.cfg.vision_tokens:
                batch["vision_embeds"] = torch.zeros(
                    (self.n_slots, self.cfg.vision_tokens, self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            with obs_trace.span("serve/prefill", tokens=int(maxlen)):
                logits, self.cache = self._model_prefill(batch)
            self.next_tok = self._greedy(logits)[:, None]
            self.stats.prefills += 1

    # -- decode ----------------------------------------------------------------
    def step(self) -> int:
        """One tick: admit if possible, then one decode step for all live
        slots.  Returns the number of requests still live."""
        if self._free_slots() and self.queue:
            self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None and not r.done]
        if not live or self.cache is None:
            return 0
        with obs_trace.span("serve/decode", live=len(live)):
            logits, self.cache = self._model_decode(
                torch.as_tensor(self.next_tok, device=self.device))
        with obs_trace.span("serve/token/decode"):
            nxt = self._greedy(logits)
        self.stats.decode_steps += 1
        for i in live:
            r = self.slots[i]
            tok = int(nxt[i])
            r.generated.append(tok)
            self.stats.tokens_out += 1
            if (r.stop_token is not None and tok == r.stop_token) or \
                    len(r.generated) >= r.max_new:
                r.done = True
                self.stats.completed += 1
                self._on_retire(i, r)
        self.next_tok = nxt[:, None]
        return len([i for i in live if not self.slots[i].done])

    def run(self, max_ticks: int = 1000) -> ServeStats:
        for _ in range(max_ticks):
            self.step()
            if not self.queue and all(r is None or r.done for r in self.slots):
                break
        self.publish_stats()
        return self.stats

    def publish_stats(self, metrics=None) -> ServeStats:
        """Bridge ServeStats into the obs metrics registry (serve/* gauges)."""
        if metrics is None:
            from repro_torch.obs.metrics import registry as metrics
        metrics.observe_serve(self.stats)
        return self.stats
