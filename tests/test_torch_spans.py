"""The spans beneath ``step/grad`` and the serving loop's phases, counted on
the CPU: the forward, backward and tiled attention of an EF-BV step with
remat; the delta apply, the model's call and the token read of every slot
call of a ``PersonalizedBatcher``; nothing recorded with tracing off.  Then the benchmark's readers of those spans on
hand-built runs, and the metrics registry's bounded series.

Every assertion counts spans or reads hand-set numbers; none reads a time.
About 10 s alone.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)
SEQ, TILE, GROUPS = 32, 8, 2


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Tracing off and an empty recorder before and after each test."""
    obs_trace.disable()
    obs_trace.get_tracer().reset()
    obs_metrics.registry.reset()
    yield
    obs_trace.disable()
    obs_trace.get_tracer().reset()
    obs_metrics.registry.reset()


def _names(spans):
    return [s.name for s in spans]


def _inside(outer, spans, name):
    """Spans of ``name`` whose host interval lies within ``outer``'s, on any
    thread (autograd's device thread runs the backward on a card)."""
    a, b = outer.ts_us, outer.ts_us + outer.dur_us
    return [s for s in spans if s.name == name and a <= s.ts_us and s.ts_us + s.dur_us <= b]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _efbv_step(monkeypatch, steps: int, trace_on: bool):
    """``steps`` EF-BV steps of reduced danube (2 layers, SWA 16) over 2
    groups, remat on, the tiled attention at 8 x 8 tiles -> the spans."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.models import attention, init_params
    from repro_torch.training.steps import init_train_state, make_train_step

    monkeypatch.setattr(attention, "BLOCK_Q", TILE)
    monkeypatch.setattr(attention, "BLOCK_K", TILE)
    cfg = get_config("h2o-danube-1.8b").reduced()
    tc = TrainConfig(model=cfg, seq_len=SEQ, global_batch=GROUPS, lr=1e-3, warmup_steps=1,
                     total_steps=10, remat="dots",
                     sync=SyncConfig(mode="efbv", compressor="qsgd_kernel", quant_bits=8))
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(gen, init_params(0, cfg, device="cpu"), tc, GROUPS, 1)
    step = make_train_step(cfg, tc, GROUPS, 1)
    toks = torch.randint(0, cfg.vocab_size, (GROUPS, SEQ + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if trace_on:
        obs_trace.enable()
    for _ in range(steps):
        state, _ = step(state, batch)
    obs_trace.disable()
    return cfg, obs_trace.get_tracer().spans()


def test_train_step_spans_beneath_step_grad(monkeypatch):
    steps = 2
    cfg, spans = _efbv_step(monkeypatch, steps, trace_on=True)
    names = _names(spans)
    L = cfg.num_layers
    # the accepted phases, as many as before
    assert names.count("step/grad") == steps * GROUPS
    assert names.count("step/sync") == steps * (GROUPS + 1)     # a bucketize per group + EF-BV
    assert names.count("step/apply") == steps
    for g in (s for s in spans if s.name == "step/grad"):
        fwd = _inside(g, spans, "step/grad/forward")
        bwd = _inside(g, spans, "step/grad/backward")
        assert len(fwd) == 1 and len(bwd) == 1
        assert g.encloses(fwd[0]) and g.encloses(bwd[0])
        # remat: each layer's attention runs in the forward and again in the
        # backward's recompute; its own backward once
        assert len(_inside(fwd[0], spans, "model/attn/forward")) == L
        assert len(_inside(bwd[0], spans, "model/attn/forward")) == L
        assert len(_inside(bwd[0], spans, "model/attn/backward")) == L
    assert names.count("model/attn/forward") == 2 * L * GROUPS * steps
    assert names.count("model/attn/backward") == L * GROUPS * steps
    assert "sync/efbv" not in names


def test_train_step_records_nothing_with_tracing_off(monkeypatch):
    _, spans = _efbv_step(monkeypatch, 1, trace_on=False)
    assert spans == [] and obs_trace.get_tracer().n_recorded == 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _store(cfg, users: int = 2):
    from repro_torch.core.compressors import make_compressor
    from repro_torch.models import init_params
    from repro_torch.serve import DeltaStore, personalize_leaves

    base = init_params(0, cfg, device="cpu")
    store = DeltaStore(base, make_compressor("top_k", k_frac=0.01), block_size=4096, seed=7)
    for u in range(users):
        store.put(u, personalize_leaves(base, 100 + u))
    return store


def _serve(trace_on: bool):
    """Two requests of two users on a 2-slot ``PersonalizedBatcher`` of
    reduced danube, run to the end -> (batcher, spans)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import BlockPool, PersonalizedBatcher
    from repro_torch.training.serving import Request

    cfg = get_config("h2o-danube-1.8b").reduced()
    store = _store(cfg)
    pool = BlockPool(store, 64, metrics=MetricsRegistry())
    b = PersonalizedBatcher(cfg, store, pool, n_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    for rid, n in enumerate((5, 8)):
        b.submit(Request(rid=rid, prompt=rng.integers(1, cfg.vocab_size, n), max_new=4,
                         user_id=rid))
    if trace_on:
        obs_trace.enable()
    b.run(max_ticks=50)
    obs_trace.disable()
    return b, obs_trace.get_tracer().spans()


def test_every_slot_call_is_traced():
    b, spans = _serve(trace_on=True)
    names = _names(spans)
    decodes = [s for s in spans if s.name == "serve/decode"]
    assert len(decodes) == b.stats.decode_steps > 0
    for d in decodes:
        # the engine runs every slot of the batch, live or not
        for name in ("serve/slot/eff", "serve/slot/decode"):
            inner = _inside(d, spans, name)
            assert len(inner) == b.n_slots, name
    assert names.count("serve/token/decode") == len(decodes)
    # the token read sits beside the decode step, not inside it
    assert not any(_inside(d, spans, "serve/token/decode") for d in decodes)
    admits = [s for s in spans if s.name == "serve/admit"]
    assert len(admits) == b.stats.prefills
    for a in admits:
        assert len(_inside(a, spans, "serve/slot/prefill")) == b.n_slots
    calls = b.n_slots * (b.stats.decode_steps + b.stats.prefills)
    # the delta path's apply is one call inside ``serve/slot/eff``; only the
    # materialized path opens ``serve/slot/debucketize``
    assert names.count("serve/slot/eff") == calls
    assert names.count("serve/slot/debucketize") == 0


def test_serving_records_nothing_with_tracing_off():
    b, spans = _serve(trace_on=False)
    assert b.stats.completed == 2 and spans == []
    assert obs_trace.get_tracer().n_recorded == 0


# ---------------------------------------------------------------------------
# the benchmark's readers of these spans
# ---------------------------------------------------------------------------
def _read(name, spans, steps=2):
    from perf_bench.harness import bench
    run = bench.Run()
    run.spans = spans
    run.numbers = {"steps": steps}
    return bench.load_py("metrics", name).read(run)


TRAIN_SPANS = [("step/grad", 50.0, 40.0),
               ("model/attn/forward", 1.0, 3.0), ("step/grad/forward", 9.0, 10.0),
               ("model/attn/forward", 1.0, 3.5), ("model/attn/backward", 2.0, 6.0),
               ("step/grad/backward", 20.0, 29.0),
               ("step/grad/forward", 9.0, 12.0), ("step/grad/backward", 20.0, 31.0),
               ("model/attn/backward", 2.0, None)]
SERVE_SPANS = [("serve/slot/eff", 0.5, 20.0), ("bench/delta_eff", 0.6, 20.1),
               ("serve/slot/debucketize", 0.2, 1.0), ("serve/slot/decode", 70.0, 60.0),
               ("serve/slot/eff", 0.7, 22.0), ("serve/slot/debucketize", 0.3, 1.0),
               ("serve/slot/decode", 80.0, 61.0), ("serve/token/decode", 4.0, 30.0),
               ("serve/token/decode", 6.0, 31.0), ("serve/admit", 99.0, 1.0)]


@pytest.mark.parametrize("name, spans, want", [
    ("fwd_ms.train", TRAIN_SPANS, (10.0 + 12.0) / 2),
    ("bwd_ms.train", TRAIN_SPANS, (29.0 + 31.0) / 2),
    ("attn_ms.train", TRAIN_SPANS, (3.0 + 3.5 + 6.0) / 2),     # a span without events: none
    ("decode_dispatch_ms.serve", SERVE_SPANS, (70.0 + 80.0) / 2),   # host ms
    ("token_wait_ms.serve", SERVE_SPANS, (4.0 + 6.0) / 2),          # host ms
    ("slot_delta_ms.serve", SERVE_SPANS, (20.0 + 22.0 + 1.0 + 1.0) / 2),
])
def test_span_readers_by_hand(name, spans, want):
    assert _read(name, spans) == pytest.approx(want)


@pytest.mark.parametrize("name", ["fwd_ms.train", "bwd_ms.train", "attn_ms.train",
                                  "decode_dispatch_ms.serve", "token_wait_ms.serve",
                                  "slot_delta_ms.serve"])
def test_span_readers_without_the_spans_read_nothing(name):
    """A program without these spans (the parent's) gives no value, no error."""
    old = [("step/grad", 1.0, 2.0), ("serve/decode", 3.0, 4.0), ("bench/delta_eff", 1.0, 1.0)]
    assert _read(name, old) is None and _read(name, []) is None


# ---------------------------------------------------------------------------
# the registry's series
# ---------------------------------------------------------------------------
def test_counter_and_gauge_series_keep_the_last_window():
    reg = obs_metrics.MetricsRegistry()
    W = obs_metrics.HIST_WINDOW
    c, g = reg.counter("serve/pool/hits"), reg.gauge("serve/pool/resident_blocks")
    for i in range(W + 7):
        c.inc(2.0, step=i)
        g.set(float(i), step=i)
    assert len(c.series) == len(g.series) == W
    assert c.total == c.value == 2.0 * (W + 7)
    assert g.value == float(W + 6)
    assert c.series[0] == (7, 2.0) and g.series[-1] == (W + 6, float(W + 6))
    d = c.to_dict()
    assert isinstance(d["series"], list) and len(d["series"]) == W
    assert d["total"] == 2.0 * (W + 7) and reg.to_dict()["metrics"][1]["value"] == W + 6
