"""Personalized-serving cells under a closed loop: the program's
``PersonalizedBatcher`` over a ``DeltaStore`` of users' compressed deltas
and a ``BlockPool`` of decoded ones.

Set-up makes the base weights and every user's dense personalization from
the seed, stores each as a certified put (the quantizer's draws made by the
benchmark from the seed), builds the pool and the batcher, pages in the
cell's ``preload_users``, and serves one request per slot with the cell's
traffic (a separate stream of the same mix) as the warm-up.

The window: each of the traffic's clients submits a request, and its next
one the moment the last completes, until ``--seconds`` have passed.  A
request's tokens are the argmax of the prefill that admitted it (its first
token) and each decode step's argmax; their times are taken on the host
after the program's own synchronizing read of them.  A prefill's answer is
read as the token the batcher feeds that slot at the next decode step.

``correct``: once the window has closed and the program's state is freed,
a sample of the finished requests drawn from the seed, with the longest
among them, is run through the plain reference on base + the user's delta,
quantized by the reference itself with the same draws.  Every prefill of
a request (its admission and each refill that re-prefilled it, left-padded
as the batcher padded it) starts a segment: the padded context, the
prefill's argmax, then the decode steps' tokens.  The number compared is
the widest gap by which a served token's reference logit lies below the
reference's best at that position.
"""
from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from perf_bench.harness import bench, compare, spans
from perf_bench.harness.devtrace import DeviceTrace
from perf_bench.harness.noise import RowNoise, tile_rows
from perf_bench.harness.traffic import ClosedLoop
from perf_bench.harness.weights import (check_program_tree, fold, leaf_specs, make_weights,
                                        personalize)
from perf_bench.reference import model as ref_model
from perf_bench.reference import train as ref_train


@dataclass
class Record:
    req: object                       # the program's Request
    client: int
    submit_t: float
    first_t: Optional[float] = None
    done_t: Optional[float] = None
    times: List[float] = field(default_factory=list)       # each served token's time
    segments: List[list] = field(default_factory=list)     # [pad, k0, slot, fed token]


def delta_noise(ctx, user: int, rows: int) -> RowNoise:
    return RowNoise(ctx.device, rows, ctx.seed, "delta", user)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


class Loop:
    """The closed loop's bookkeeping around the program's batcher."""

    def __init__(self, batcher, traffic: ClosedLoop, cuda: bool, rid0: int = 0):
        self.b, self.traffic, self.cuda = batcher, traffic, cuda
        self.records: dict = {}
        self.next_rid = rid0
        if not hasattr(batcher, "_bench_prefill"):
            batcher._bench_prefill = batcher._model_prefill
            batcher._bench_decode = batcher._model_decode
        orig, orig_decode = batcher._bench_prefill, batcher._bench_decode

        def prefill(batch):
            logits, cache = orig(batch)
            _sync(self.cuda)
            t = bench.now()
            L = batch["tokens"].shape[1]
            for i, r in enumerate(self.b.slots):
                rec = None if r is None or r.done else self.records.get(r.rid)
                if rec is None:
                    continue
                rec.segments.append([L - len(r.prompt) - len(r.generated), len(r.generated),
                                     i, None])
                if rec.first_t is None:
                    rec.first_t = t
                    rec.times.append(t)
            return logits, cache

        def decode(tok):
            # the token a slot is fed after a prefill is that prefill's answer
            for i, r in enumerate(self.b.slots):
                rec = None if r is None else self.records.get(r.rid)
                if rec is not None and rec.segments and rec.segments[-1][3] is None:
                    rec.segments[-1][3] = int(self.b.next_tok[i, 0])
            return orig_decode(tok)

        batcher._model_prefill = prefill
        batcher._model_decode = decode

    def submit(self, client: int, max_new_cap: Optional[int] = None) -> None:
        from repro_torch.training.serving import Request
        spec = self.traffic.next(client)
        out = spec.out_len if max_new_cap is None else min(spec.out_len, max_new_cap)
        req = Request(rid=self.next_rid, prompt=self.traffic.prompt(spec), max_new=out,
                      user_id=spec.user)
        self.next_rid += 1
        self.records[req.rid] = Record(req, client, bench.now())
        self.b.submit(req)

    def step(self, resubmit: bool, max_new_cap: Optional[int] = None) -> None:
        before = {r.rid: len(r.generated) for r in self.b.slots if r is not None}
        self.b.step()
        t = bench.now()
        for r in self.b.slots:
            rec = None if r is None else self.records.get(r.rid)
            if rec is None:
                continue
            for _ in range(len(r.generated) - before.get(r.rid, 0)):
                rec.times.append(t)
            if r.done and rec.done_t is None:
                rec.done_t = t
                if resubmit:
                    self.submit(rec.client, max_new_cap)

    def idle(self) -> bool:
        return not self.b.queue and all(r is None or r.done for r in self.b.slots)


def _time_page_ins(pool, page_in_ms: list, cuda: bool) -> None:
    """The traced run's host time of each page-in (a pool ``acquire`` of a
    user not resident, synchronized on both sides)."""
    acquire = pool.acquire

    def timed_acquire(uid):
        if pool.is_resident(uid):
            return acquire(uid)
        _sync(cuda)
        a = bench.now()
        e = acquire(uid)
        _sync(cuda)
        page_in_ms.append((bench.now() - a) * 1e3)
        return e

    pool.acquire = timed_acquire


def run(ctx: bench.Context) -> bench.Run:
    from repro_torch.core.compressors import make_compressor
    from repro_torch.models import init_params
    from repro_torch.serve import BlockPool, DeltaStore, PersonalizedBatcher

    cfg, cell, tr, dev = ctx.config, ctx.cell, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    pcfg = compare.program_config(cfg)
    specs = leaf_specs(cfg)
    check_program_tree(specs, init_params(0, pcfg, device="meta"))
    dl = cell["delta"]
    d = sum(s.numel for s in specs)

    # ---------------------------------------------------------------- set-up
    spans.enable(ctx.trace and cuda)
    base = make_weights(ctx.seed, cfg, dev)
    store = DeltaStore(base.tree(), compressor=make_compressor("qsgd_kernel", bits=dl["bits"]),
                       block_size=dl["block"], seed=fold(ctx.seed, "store") % (1 << 31))
    rows = tile_rows(store.layout.padded_d)
    user_w = None
    for u in range(tr["users"]):
        user_w = personalize(base, ctx.seed, u, dl["rel_scale"], out=user_w)
        noise = delta_noise(ctx, u, rows).materialize()
        store.put(u, user_w.tree(), noise=noise)
        del noise
    del user_w, base
    gc.collect()
    pool = BlockPool(store, capacity_blocks=cell["pool_users"] * store.layout.n_buckets)
    batcher = PersonalizedBatcher(pcfg, store, pool, n_slots=cell["slots"],
                                  max_len=cell["max_len"])
    for u in range(cell.get("preload_users", 0)):
        pool.acquire(u)
        pool.release(u)
    warm = Loop(batcher, ClosedLoop(tr, fold(ctx.seed, "warm-up"), cfg["vocab_size"]), cuda)
    for c in range(min(tr["clients"], cell["slots"])):
        warm.submit(c, max_new_cap=cell["warmup_max_new"])
    while not warm.idle():
        warm.step(resubmit=False)
    _sync(cuda)

    # ---------------------------------------------------------------- window
    loop = Loop(batcher, ClosedLoop(tr, ctx.seed, cfg["vocab_size"]), cuda, warm.next_rid)
    page_in_ms: List[float] = []
    if ctx.trace and cuda:
        _time_page_ins(pool, page_in_ms, cuda)
    spans.reset()
    hits0, miss0 = pool.hits, pool.misses
    trace_cm = DeviceTrace() if (ctx.trace and cuda) else contextlib.nullcontext()
    with trace_cm as dtrace:
        t0 = bench.now()
        setup_s = t0 - ctx.t0
        for c in range(tr["clients"]):
            loop.submit(c)
        while bench.now() - t0 < ctx.seconds:
            loop.step(resubmit=True)
        t1 = bench.now()
    run = bench.Run(config=cfg, cell=cell, traffic=tr)
    run.window_s = t1 - t0
    recs = list(loop.records.values())
    times = [t for r in recs for t in r.times]
    gaps = [(b - a) * 1e3 for r in recs for a, b in zip(r.times, r.times[1:])]
    ttft = [(r.first_t - r.submit_t) * 1e3 for r in recs if r.first_t is not None]
    run.attempted = len(recs)
    run.metrics = {"serve_tokens_per_s": len(times) / run.window_s,
                   "itl_p95_ms": float(np.percentile(gaps, 95)) if gaps else float("nan"),
                   "ttft_p50_ms": float(np.median(ttft)) if ttft else float("nan"),
                   "setup_s": setup_s}
    hits, misses = pool.hits - hits0, pool.misses - miss0
    run.numbers = {"requests_done": sum(r.done_t is not None for r in recs),
                   "tokens": len(times), "hits": hits, "misses": misses,
                   "prompt_tokens": sum(len(r.req.prompt) for r in recs if r.first_t),
                   "d": d, "delta_elems": store.layout.padded_d}
    run.series = {"page_in_ms": page_in_ms,
                  "token_ctx": [len(r.req.prompt) + j for r in recs
                                for j in range(len(r.times))],
                  "prompt_lens": [len(r.req.prompt) for r in recs if r.first_t]}
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if ctx.trace and cuda:
        run.spans, host = spans.collect()
        run.trace = dtrace
        run.series["host_spans"] = host
    spans.enable(False)
    done = [r for r in recs if r.done_t is not None]
    sample = _sample(done, ctx.seed, cell["check_tokens"])
    samples = [(r.req.user_id, np.asarray(r.req.prompt), list(r.req.generated),
                [(pad, k0, a) for pad, k0, _, a in r.segments]) for r in sample]
    del loop, warm, batcher, pool, store, recs, done, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- reference
    t_ref = bench.now()
    gap, as_fed, ctl = reference(ctx, specs, samples, rows)
    run.numbers["reference_s"] = bench.now() - t_ref
    # a run that finished no request has nothing judged: not correct
    run.checks = [bench.limit_check(cell, "served_gap", gap if samples else float("inf"))]
    run.numbers.update(served_gap_as_fed=as_fed, checked_requests=len(samples),
                       checked_tokens=sum(len(g) + 1 for _, _, g, _ in samples))
    if ctx.control:
        run.control = [bench.limit_check(cell, "served_gap", ctl if samples else float("inf"))]
    return run


def _sample(done: list, seed: int, want_tokens: int) -> list:
    """The longest finished request, then others drawn from the seed until
    ``want_tokens`` served tokens are covered."""
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.generated))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(fold(seed, "sample") % (1 << 63)).permutation(len(rest))
    out, n = [longest], len(longest.times)
    for i in order:
        if n >= want_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].times)
    return out


def stream_inputs(prompt, gen, segs):
    """What the user was served, judged as the greedy continuation of the
    prompt alone: (prompt + the stream but its last token, the first
    position read, the stream: the admitting prefill's answer and then
    every token of ``generated``)."""
    served = [segs[0][2]] + list(gen)
    return np.concatenate([prompt, np.asarray(served[:-1], np.int64)]), len(prompt) - 1, served


def segment_inputs(prompt, gen, segs):
    """Each prefill's segment as the model computed it: (the context as the
    batcher padded it + the prefill's answer + the decode tokens up to the
    next prefill, the first position read, the tokens that segment
    produced)."""
    out = []
    for j, (pad, k0, a) in enumerate(segs):
        k1 = segs[j + 1][1] if j + 1 < len(segs) else len(gen)
        ctx = np.concatenate([np.zeros(pad, np.int64), prompt, np.asarray(gen[:k0], np.int64)])
        served = [a] + list(gen[k0:k1])
        seq = np.concatenate([ctx, np.asarray(served[:-1], np.int64)])
        out.append((seq, len(ctx) - 1, served))
    return out


def _gaps(params, cfg, dev, seq, p0, served, control: bool):
    """(the widest gap of a served token below the reference's best, and
    with ``control`` the widest gap of the float8 reference's own picks)."""
    tok = torch.as_tensor(seq, device=dev)[None]
    pos = slice(p0, p0 + len(served))
    lg = ref_model.logits(params, cfg, ref_model.hidden(params, cfg, tok)[:, pos])[0]
    best = lg.max(-1).values
    idx = torch.as_tensor(served, device=dev)
    gap = float((best - lg.gather(-1, idx[:, None])[:, 0]).max())
    ctl = 0.0
    if control:
        l8 = ref_model.logits(params, cfg, ref_model.hidden(params, cfg, tok, fp8=True)[:, pos],
                              fp8=True)[0]
        ctl = float((best - lg.gather(-1, l8.argmax(-1)[:, None])[:, 0]).max())
    return gap, ctl


@torch.no_grad()
def reference(ctx, specs, samples, rows: int):
    """-> (the widest gap of a token of a served stream, the widest gap of a
    token as the model computed it (``segment_inputs``), and with
    ``ctx.control`` the float8 reference's widest gap on the streams)."""
    cfg, dl, dev = ctx.config, ctx.cell["delta"], ctx.device
    ref_model.exact_f32()
    base = make_weights(ctx.seed, cfg, dev)
    base_flat = base.flat_f32()
    gap, as_fed, ctl = 0.0, 0.0, 0.0
    for user in sorted({s[0] for s in samples}):
        pers = personalize(base, ctx.seed, user, dl["rel_scale"])
        eff = pers.flat_f32()
        del pers
        eff.sub_(base_flat)
        ref_train.qsgd_(eff, delta_noise(ctx, user, rows), dl["bits"])
        eff.add_(base_flat)
        params = ref_train.param_views(eff, specs)
        for u, prompt, gen, segs in samples:
            if u != user:
                continue
            g, c = _gaps(params, cfg, dev, *stream_inputs(prompt, gen, segs), ctx.control)
            gap, ctl = max(gap, g), max(ctl, c)
            for seq, p0, served in segment_inputs(prompt, gen, segs):
                as_fed = max(as_fed, _gaps(params, cfg, dev, seq, p0, served, False)[0])
        del params, eff
    return gap, as_fed, ctl
