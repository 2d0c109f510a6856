"""The serving engine's one parameter tree and its CUDA-graph decode step.

On the CPU: the tree the delta apply writes in place equals
``debucketize(eff)`` leaf by leaf, bit for bit, at fixed addresses; a slot
that serves user A and then user B decodes with B's parameters and the
state B's prefill left; which configs may graph their decode (a function of
the config and the device alone); the ``serve/graph/*`` counters, all
eager here, and the report's line for them.

On the card (``cuda``, skipped without one): a reduced mamba2 served by a
2-slot ``PersonalizedBatcher`` over 3 users gives the same greedy tokens
with graphs as eagerly, logits within bf16 rounding, one capture a slot
and a replay for every later slot decode call; the delta apply runs as
kernel D1 at every slot call (the wrapper's launches), its tree bit for bit
``debucketize(eff)`` at fixed addresses, and the delta path's logits bit
for bit the materialized path's.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.comm.buckets import debucketize
from repro_torch.configs import get_config
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.tree import tree_flatten

torch.set_num_threads(2)


def _cfg(arch: str, layers: int = 2):
    """The reduced config in bf16 (f32 leaves stay f32: mamba's ``a_log``,
    ``dt_bias``, ``D``), so the tree holds both dtypes."""
    return replace(get_config(arch).reduced(), num_layers=layers, dtype="bfloat16")


def _world(cfg, users: int, device="cpu"):
    from repro_torch.core.compressors import make_compressor
    from repro_torch.models import init_params
    from repro_torch.serve import BlockPool, DeltaStore, personalize_leaves

    base = init_params(0, cfg, device=device)
    store = DeltaStore(base, make_compressor("top_k", k_frac=0.05), block_size=4096, seed=3)
    for u in range(users):
        store.put(u, personalize_leaves(base, 100 + u, match=("norm", "proj"), scale=0.2))
    metrics = MetricsRegistry()
    return store, BlockPool(store, 256, metrics=metrics), metrics


def _serve(cfg, store, pool, n_slots: int, reqs):
    """Serve ``reqs`` (user, prompt, max_new) to the end -> (batcher, each
    request's tokens, each decode step's logits)."""
    from repro_torch.serve import PersonalizedBatcher
    from repro_torch.training.serving import Request

    b = PersonalizedBatcher(cfg, store, pool, n_slots=n_slots, max_len=48)
    decode, steps = b._model_decode, []

    def logged(tok):
        logits, cache = decode(tok)
        steps.append(logits.float().cpu())
        return logits, cache

    b._model_decode = logged
    rs = [Request(rid=i, prompt=np.asarray(p, np.int64), max_new=m, user_id=u)
          for i, (u, p, m) in enumerate(reqs)]
    for r in rs:
        b.submit(r)
    b.run(max_ticks=200)
    assert all(r.done for r in rs)
    return b, [r.generated for r in rs], steps


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_engine_tree_equals_debucketize_bitwise(arch):
    """Each slot call's delta apply, and the materialized path's cast of the
    same ``eff``, write the engine's one tree in place: every leaf equals
    ``debucketize(eff)``'s in dtype and bits, and no leaf moves between
    calls (a captured graph reads these addresses)."""
    from repro_torch.serve import DeltaServeEngine

    cfg = _cfg(arch)
    store, pool, _ = _world(cfg, users=2)
    eng = DeltaServeEngine(cfg, store, max_len=32)
    dtypes = {str(l.dtype) for l in tree_flatten(debucketize(store.base_blocks,
                                                             store.layout))[0]}
    assert "torch.bfloat16" in dtypes
    ptrs = None
    for table in [pool.acquire(u).table for u in (0, 1)] + [torch.zeros_like(pool.table_for(0))]:
        eff = torch.index_select(pool.blocks, 0, table) + store.base_blocks
        want = tree_flatten(debucketize(eff, store.layout))[0]
        for tree in (eng._apply_delta(pool, table), eng._load_params(eff)):
            assert tree is eng._params
            got = tree_flatten(tree)[0]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
            now = [g.data_ptr() for g in got]
            assert ptrs is None or now == ptrs
            ptrs = now


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_a_slot_switching_users_reads_the_new_users_params_and_state(arch):
    """One slot serves user 0, then user 1, on the same prompt: every
    decode step of user 1's request has the logits of user 1 served alone,
    bit for bit (no stale parameter or state of user 0), and the two users'
    logits differ."""
    cfg = _cfg(arch)
    store, pool, _ = _world(cfg, users=2)
    prompt = list(range(3, 12))
    _, toks, steps = _serve(cfg, store, pool, 1, [(0, prompt, 4), (1, prompt, 4)])
    alone = []
    for u in (0, 1):
        _, t, s = _serve(cfg, store, pool, 1, [(u, prompt, 4)])
        assert t[0] == toks[u]
        alone.append(s)
    assert len(steps) == len(alone[0]) + len(alone[1])
    for a, b in zip(steps, alone[0] + alone[1]):
        assert torch.equal(a, b)
    assert not torch.equal(alone[0][0], alone[1][0])


@pytest.mark.parametrize("arch, mamba_only", [
    ("mamba2-2.7b", True), ("h2o-danube-1.8b", False), ("qwen1.5-4b", False),
    ("dbrx-132b", False), ("jamba-1.5-large-398b", False), ("llama4-scout-17b-a16e", False),
    ("nemotron-4-15b", False), ("chameleon-34b", False)])
def test_decode_graph_eligibility_follows_the_config_and_the_device(arch, mamba_only):
    """Only an all-Mamba config without experts graphs its decode, and only
    on a CUDA device; asked of the config, no card needed."""
    from repro_torch.serve.engine import decode_graph_eligible

    for cfg in (get_config(arch), get_config(arch).reduced()):
        assert decode_graph_eligible(cfg, "cuda") is mamba_only
        assert decode_graph_eligible(cfg, torch.device("cuda", 0)) is mamba_only
        assert decode_graph_eligible(cfg, "cpu") is False


def test_a_mamba_config_that_routes_experts_is_not_eligible():
    from repro_torch.serve.engine import decode_graph_eligible

    cfg = get_config("mamba2-2.7b").reduced()
    moe = replace(cfg, moe=get_config("jamba-1.5-large-398b").reduced().moe, moe_every=1,
                  d_ff=256)
    assert decode_graph_eligible(cfg, "cuda")
    assert not decode_graph_eligible(moe, "cuda")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_on_the_cpu_every_slot_decode_call_counts_eager(arch):
    cfg = _cfg(arch)
    store, pool, metrics = _world(cfg, users=2)
    b, _, steps = _serve(cfg, store, pool, 2, [(0, [5, 6, 7], 3), (1, [8, 9], 5),
                                               (None, [4, 4, 4, 4], 2)])
    assert not b.engine.graphed
    assert metrics.get("serve/graph/eager").total == 2 * len(steps) == \
        2 * b.stats.decode_steps
    assert metrics.get("serve/graph/captures") is None
    assert metrics.get("serve/graph/replays") is None


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_on_the_cpu_every_delta_apply_runs_the_plain_version(arch):
    """The delta path's slot calls, prefill and decode, launch no D1 and
    the engine builds no work list for it."""
    from repro_torch.kernels import delta_apply

    cfg = _cfg(arch)
    store, pool, metrics = _world(cfg, users=2)
    before = delta_apply.delta_apply.launches
    b, _, _ = _serve(cfg, store, pool, 2, [(0, [5, 6, 7], 3), (1, [8, 9], 5)])
    assert b.stats.decode_steps + b.stats.prefills > 0
    assert b.engine._params is not None and b.engine._work is None
    assert delta_apply.delta_apply.launches == before


def test_report_prints_the_graph_counters(tmp_path):
    from repro_torch.obs import report

    obs_trace.get_tracer().reset()
    obs_trace.enable()
    try:
        with obs_trace.span("serve/decode"):
            pass
    finally:
        obs_trace.disable()
    trace = obs_trace.export_jsonl(str(tmp_path / "trace.jsonl"))
    obs_trace.get_tracer().reset()
    reg = MetricsRegistry()
    reg.counter("serve/graph/captures").inc(2)
    reg.counter("serve/graph/replays").inc(38)
    reg.counter("serve/graph/eager").inc(0)
    metrics = reg.export_json(str(tmp_path / "metrics.json"))
    text, res = report.build_report(trace, metrics_path=metrics, device="cpu")
    assert "    graph  captures=2  eager=0  replays=38" in text.splitlines()
    assert res["serve_stats"]["graph/replays"] == 38


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none present)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graphed_decode_gives_the_eager_tokens(cuda_device, monkeypatch):
    """Reduced mamba2 (d 128, 4 layers, bf16), 2 slots, 3 users, requests
    that switch users on a slot: the graphs' greedy tokens equal the eager
    run's, logits within bf16 rounding; one capture a slot, a replay for
    every later slot decode call, no eager call."""
    import repro_torch.serve.engine as engine_mod

    cfg = _cfg("mamba2-2.7b", layers=4)
    assert cfg.d_model == 128
    rng = np.random.default_rng(0)
    reqs = [(u, rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for u, n, m in ((0, 7, 6), (1, 12, 9), (2, 5, 4), (1, 9, 7), (0, 16, 5),
                            (2, 11, 8), (None, 6, 4))]
    runs = {}
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(engine_mod, "decode_graph_eligible", lambda cfg, device: False)
        store, pool, metrics = _world(cfg, users=3, device=cuda_device)
        b, toks, steps = _serve(cfg, store, pool, 2, reqs)
        assert b.engine.graphed is graphed
        calls = b.n_slots * b.stats.decode_steps
        count = lambda name: (metrics.get(f"serve/graph/{name}").total
                              if metrics.get(f"serve/graph/{name}") else 0)
        if graphed:
            assert count("captures") == b.n_slots
            assert count("replays") == calls - b.n_slots
            assert count("eager") == 0
        else:
            assert count("eager") == calls and count("captures") == count("replays") == 0
        runs[graphed] = toks, steps
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == len(runs[False][1])
    for g, e in zip(runs[True][1], runs[False][1]):
        scale = float(e.abs().max())
        torch.testing.assert_close(g, e, rtol=2.0 ** -7, atol=2.0 ** -7 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_on_the_card_the_delta_apply_is_d1_and_writes_debucketize_bitwise(cuda_device, arch):
    """Every delta-path slot call, prefill and decode, runs D1 once
    (the wrapper's launches); the engine's tree after
    an apply equals ``debucketize(eff)`` leaf by leaf in dtype and bits, at
    the addresses it had."""
    from repro_torch.kernels import delta_apply
    from repro_torch.serve import DeltaServeEngine

    cfg = _cfg(arch)
    store, pool, metrics = _world(cfg, users=2, device=cuda_device)
    eng = DeltaServeEngine(cfg, store, max_len=32, metrics=metrics)
    ptrs = None
    for table in [pool.acquire(u).table for u in (0, 1)] + [torch.zeros_like(pool.table_for(0))]:
        tree = eng._apply_delta(pool, table)
        eff = torch.index_select(pool.blocks, 0, table) + store.base_blocks
        want = tree_flatten(debucketize(eff, store.layout))[0]
        got = tree_flatten(tree)[0]
        for g, w in zip(got, want):
            bits = {2: torch.int16, 4: torch.int32}[w.element_size()]
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.view(bits), w.view(bits))
        now = [g.data_ptr() for g in got]
        assert ptrs is None or now == ptrs
        ptrs = now
    before = delta_apply.delta_apply.launches
    b, _, _ = _serve(cfg, store, pool, 2, [(0, [5, 6, 7], 3), (1, [8, 9], 5),
                                           (None, [4, 4, 4, 4], 2)])
    calls = b.n_slots * (b.stats.decode_steps + b.stats.prefills)
    assert delta_apply.delta_apply.launches - before == calls > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_delta_path_bitwise_equals_materialized_on_the_card(cuda_device, arch):
    """Three slots (two users and the bare base): the delta path's logits
    (D1 into the tree) equal the materialized path's (``debucketize`` of
    each user's materialized blocks into the same tree), bit for bit, in
    prefill and every decode step; mamba2's decode steps are graphs."""
    from repro_torch.kernels import delta_apply
    from repro_torch.serve import DeltaServeEngine

    cfg = _cfg(arch)
    store, pool, metrics = _world(cfg, users=2, device=cuda_device)
    eng = DeltaServeEngine(cfg, store, max_len=32, metrics=metrics)
    before = delta_apply.delta_apply.launches
    tables = torch.stack([pool.acquire(u).table for u in range(2)] +
                         [torch.zeros_like(pool.table_for(0))])
    eff = eng.eff_blocks_for([store.personalized_params(0), store.personalized_params(1),
                              debucketize(store.base_blocks, store.layout)])
    toks = torch.arange(1, 34, device=cuda_device).reshape(3, 11)
    logits, cache = eng.prefill(pool, tables, toks)
    lm, cm = eng.prefill_materialized(eff, toks)
    assert torch.equal(logits, lm)
    for _ in range(4):
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        logits, cache = eng.decode(pool, tables, tok, cache)
        lm, cm = eng.decode_materialized(eff, tok, cm)
        assert torch.equal(logits, lm)
    assert delta_apply.delta_apply.launches - before == 3 * 5
