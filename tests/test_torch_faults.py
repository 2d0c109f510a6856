"""The port's lossy-link transmit (``repro_torch.faults.transmit``), the
ledger's retry accounting and the metrics registry's observers against the
JAX package, on the CPU.

Tolerance: none.  Attempt decisions, attempt and drop/corrupt counts,
backoff, error messages, ledger records, the corrupted byte, registry
series and exported JSON are all equal to the JAX package's.  Each
attempt's decision also equals ``FaultModel.attempt_outcomes`` at the lane
the attempt draws (``attempt * n_children + child`` on the attempt-0
stream).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import ledger as tledger
from repro_torch.comm.topology import Link as TLink
from repro_torch.comm.tree import TreeLevel as TLevel
from repro_torch.comm.tree import TreeTopology as TTree
from repro_torch.core import compressors as tcomp
from repro_torch.faults import (RETRY_TAG, FaultConfig, FaultModel, corrupt_payload,
                                expected_transmissions, transmit)
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(2)
CPU = torch.device("cpu")
XMIT_CONFIGS = [dict(seed=1, drop_rate=0.6, max_retries=3),
                dict(seed=4, corrupt_rate=0.5, max_retries=4),
                dict(seed=7, drop_rate=0.2, corrupt_rate=0.2, max_retries=3),
                dict(seed=9, drop_rate=0.4, max_retries=0)]


@pytest.fixture(scope="module")
def jx():
    import importlib

    import jax
    import jax.numpy as jnp
    from repro.comm import codecs as jcodecs
    from repro.comm import ledger as jledger
    from repro.core import compressors as jcomp
    jtransmit = importlib.import_module("repro.faults.transmit")
    from repro.faults import FaultConfig as JFault
    from repro.obs import metrics as jmetrics
    return dict(jax=jax, jnp=jnp, codecs=jcodecs, ledger=jledger, comp=jcomp,
                transmit=jtransmit, Fault=JFault, metrics=jmetrics)


def _payloads(jx, d=512, name="top_k", kw=None):
    """The same message encoded by both packages (a deterministic compressor,
    so the planes are equal byte for byte)."""
    kw = {"k_frac": 0.1} if kw is None and name == "top_k" else (kw or {})
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    jp = jx["codecs"].encode(jx["comp"].make_compressor(name, **kw),
                             jx["jax"].random.PRNGKey(0), jx["jnp"].asarray(x))
    tp = tcodecs.encode(tcomp.make_compressor(name, **kw), torch.from_numpy(x))
    assert jp.planes.keys() == tp.planes.keys()
    for k in jp.planes:
        assert np.asarray(jp.planes[k]).tobytes() == tp.planes[k].tobytes(), k
    return jp, tp


def _result(r):
    return (r.delivered, r.attempts, r.n_dropped, r.n_corrupt, r.backoff_s, r.error)


@pytest.mark.parametrize("cfg", XMIT_CONFIGS, ids=lambda c: f"seed{c['seed']}")
def test_transmit_equals_jax_and_attempt_outcomes(jx, cfg):
    n = 16
    jp, tp = _payloads(jx)
    tree = TTree("t", (TLevel("uplink", n, TLink(gbps=1.0, latency_us=100.0)),))
    fm = FaultModel(FaultConfig(**cfg), tree)
    jl, tl = jx["ledger"].CommLedger(), tledger.CommLedger()
    attempts = 0
    for child in range(n):
        want = jx["transmit"].transmit(jp, jx["Fault"](**cfg), rnd=0, level_name="uplink",
                                       n_children=n, child=child, ledger=jl)
        got = transmit(tp, FaultConfig(**cfg), rnd=0, level_name="uplink", n_children=n,
                       child=child, ledger=tl)
        assert _result(got) == _result(want), child
        # replay the decisions from the plan-level fault model
        dropped = corrupted = 0
        for k in range(got.attempts):
            d, c, _ = fm.attempt_outcomes(0, 0, 0, lanes=np.array([k * n + child]))
            if k == 0:
                d0, c0, _ = fm.attempt_outcomes(0, 0, 0)
                assert (d[0], c[0]) == (d0[child], c0[child])
            delivered = not (d[0] or c[0])
            assert delivered == (got.delivered and k == got.attempts - 1), (child, k)
            dropped, corrupted = dropped + int(d[0]), corrupted + int(c[0])
        assert (dropped, corrupted) == (got.n_dropped, got.n_corrupt)
        if got.delivered:
            assert got.payload is tp
            assert torch.equal(tcodecs.decode(got.payload, device=CPU),
                               torch.from_numpy(np.array(jx["codecs"].decode(jp))))
        attempts += got.attempts
    assert [dataclasses.astuple(r) for r in tl.records] == \
           [dataclasses.astuple(r) for r in jl.records]
    by_tag = tl.bytes_by_tag()
    assert by_tag["uplink"] == n * tp.nbytes
    assert tl.retry_bytes == (attempts - n) * tp.nbytes == jl.retry_bytes
    assert by_tag.get(RETRY_TAG, 0) == tl.retry_bytes
    assert tl.bits_per_node(n) == jl.bits_per_node(n)
    assert tl.bits_per_node(0) == jl.bits_per_node(0)


@pytest.mark.parametrize("name,kw", [("top_k", None), ("identity", {}),
                                     ("qsgd", {"bits": 8, "stochastic": False})])
def test_corrupt_payload_flips_the_byte_jax_flips(jx, name, kw):
    jp, tp = _payloads(jx, d=777, name=name, kw=kw)
    tcodecs.seal_payload(tp)
    jx["codecs"].seal_payload(jp)
    plane = corrupt_payload(tp, rnd=3, lane=5, seed=2)
    assert plane == jx["transmit"].corrupt_payload(jp, rnd=3, lane=5, seed=2)
    for k in jp.planes:
        assert np.asarray(jp.planes[k]).tobytes() == tp.planes[k].tobytes(), k
    with pytest.raises(tcodecs.PayloadError, match=plane) as ei:
        tcodecs.decode(tp, device=CPU)
    assert ei.value.plane == plane
    empty = tcodecs.Payload("dense", (0,), "float32", {"values": np.zeros(0, np.float32)})
    assert corrupt_payload(empty) is None


def test_corrupted_transmit_retries_and_recovers():
    cfg = FaultConfig(seed=4, corrupt_rate=0.5, max_retries=4)
    p = tcodecs.encode(tcomp.top_k(0.1), torch.randn(512, generator=torch.Generator().manual_seed(0)))
    results = [transmit(p, cfg, rnd=0, level_name="uplink", n_children=16, child=i)
               for i in range(16)]
    assert any(r.n_corrupt > 0 for r in results)
    assert all(r.error is not None and "checksum mismatch" in r.error
               for r in results if r.n_corrupt)
    for r in results:
        if r.delivered:
            tcodecs.verify_payload(r.payload)


def test_expected_transmissions_and_tags_equal_jax(jx):
    for q in (-0.1, 0.0, 0.05, 0.3, 0.9, 1.0, 1.5):
        for r in (0, 1, 3, 6):
            assert expected_transmissions(q, r) == \
                   jx["transmit"].expected_transmissions(q, r)
    assert RETRY_TAG == tledger.RETRY_TAG == jx["transmit"].RETRY_TAG == \
           jx["ledger"].RETRY_TAG


# ---------------------------------------------------------------------------
# the metrics registry
# ---------------------------------------------------------------------------
def test_histogram_equals_jax(jx):
    vals = np.random.default_rng(1).standard_normal(1500).tolist()
    jh = jx["metrics"].Histogram("h", window=64)
    th = tmetrics.Histogram("h", window=64)
    for i, v in enumerate(vals):
        jh.observe(v, step=i)
        th.observe(v, step=i)
    assert th.to_dict() == jh.to_dict()
    for q in (0, 1, 50, 99, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert tmetrics.Histogram("e").to_dict() == jx["metrics"].Histogram("e").to_dict()
    reg = tmetrics.MetricsRegistry()
    reg.histogram("a").observe(1.0)
    reg.counter("b").inc(2)
    assert reg.names() == ["a", "b"]
    with pytest.raises(TypeError, match="histogram"):
        reg.gauge("a")
    reg.reset()
    assert reg.names() == []


def _sync_configs(jx):
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    out = []
    for mod in (jbase, tbase):
        out.append([
            mod.SyncConfig(mode="efbv", compressor="top_k", compress_ratio=0.05),
            mod.SyncConfig(mode="hier", topology="edge_fl_tree", levels=(
                mod.LevelConfig("uplink", 2, "top_k", 0.05),
                mod.LevelConfig("metro", 4, "qsgd", quant_bits=8),
                mod.LevelConfig("wan", 4, "top_k", 0.01)))])
    return out


def test_registry_observers_equal_jax(jx, tmp_path):
    """The same RoundCost, ledger and fault plan through both registries."""
    from repro.comm import round_cost as jround_cost
    from repro.comm import round_ledger as jround_ledger
    from repro.comm.tree import get_tree_topology as jtree
    from repro.faults import FaultModel as JModel
    from repro_torch.comm import round_cost as tround_cost
    from repro_torch.comm import round_ledger as tround_ledger
    from repro_torch.comm.tree import get_tree_topology as ttree

    jreg, treg = jx["metrics"].MetricsRegistry(), tmetrics.MetricsRegistry()
    (jefbv, jhier), (tefbv, thier) = _sync_configs(jx)
    n_params = 1 << 14
    for rnd, (js, ts) in enumerate(((jefbv, tefbv), (jhier, thier))):
        jreg.observe_round_cost(rnd, jround_cost(js, n_params))
        treg.observe_round_cost(rnd, tround_cost(ts, n_params, device=CPU))
    jreg.ingest_ledger(jround_ledger(jhier, n_params, n_rounds=3))
    treg.ingest_ledger(tround_ledger(thier, n_params, n_rounds=3, device=CPU))
    cfg = dict(seed=5, availability=0.8, drop_rate=0.1, corrupt_rate=0.05,
               straggler_rate=0.2, straggler_sigma=0.5, max_retries=2)
    jm = JModel(jx["Fault"](**cfg), jtree("edge_fl_tree"))
    tm = FaultModel(FaultConfig(**cfg), ttree("edge_fl_tree"))
    for rnd in range(3):
        jreg.observe_fault_plan(rnd, jm.round_plan(rnd))
        treg.observe_fault_plan(rnd, tm.round_plan(rnd))
        jreg.observe_train_step(rnd, {"loss": 2.5 - rnd, "grad_norm": 0.5 * rnd})
        treg.observe_train_step(rnd, {"loss": 2.5 - rnd, "grad_norm": 0.5 * rnd})
    assert treg.names() == jreg.names()
    assert treg.to_dict() == jreg.to_dict()
    for fn in ("level_bytes", "ledger_bytes", "fault_stats", "serve_stats"):
        assert getattr(treg, fn)() == getattr(jreg, fn)(), fn
    assert set(treg.level_bytes()) == {"inter", "intra", "uplink", "metro", "wan"}
    assert treg.fault_stats()["round_time_s"] > 0
    extra = {"run": "faults"}
    tpath = treg.export_json(str(tmp_path / "t.json"), extra=extra)
    jpath = jreg.export_json(str(tmp_path / "j.json"), extra=extra)
    assert open(tpath).read() == open(jpath).read()
    assert json.loads(open(tpath).read())["metrics"] == \
           json.loads(json.dumps(treg.to_dict()))["metrics"]


def test_traced_train_fills_the_registry():
    """With tracing on, ``training.loop.train`` feeds the process registry:
    the round cost, each step's fault plan and fetched metrics."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.obs import registry
    from repro_torch.obs import trace as obs_trace
    from repro_torch.training.loop import train

    cfg = get_config("h2o-danube-1.8b").reduced()
    tc = TrainConfig(model=cfg, seq_len=16, global_batch=4, lr=3e-3, warmup_steps=2,
                     total_steps=3, sync=SyncConfig(mode="hier", compressor="top_k",
                                                    sync_period=1,
                                                    faults=FaultConfig(seed=1, availability=0.5)))
    it = lm_batch_iterator(SyntheticLMDataset(cfg.vocab_size, 5000, seed=0), 4, 16, seed=1)
    registry.reset()
    obs_trace.enable()
    try:
        _, hist = train(cfg, tc, it, n_groups=2, n_pods=2, steps=3, device="cpu",
                        log=lambda m: None)
    finally:
        obs_trace.disable()
        obs_trace.get_tracer().reset()
    names = registry.names()
    try:
        for k in ("loss", "grad_norm"):
            g = registry.get(f"train/{k}")
            assert [s for s, _ in g.series] == [0, 1, 2]
            assert [v for _, v in g.series] == [h[k] for h in hist]
        assert registry.level_bytes() and all(n in names for n in
                                              ("comm/bytes/inter", "comm/model/round_time_s"))
        assert registry.get("faults/unavailable").series[0][0] == 0
        assert len(registry.get("faults/round_time_s").series) == 3
        assert any(n.startswith("faults/survivor_frac/") for n in names)
    finally:
        registry.reset()
    # tracing off: nothing is observed
    train(cfg, tc, lm_batch_iterator(SyntheticLMDataset(cfg.vocab_size, 5000, seed=0), 4, 16,
                                     seed=1), n_groups=2, n_pods=2, steps=1, device="cpu",
          log=lambda m: None)
    assert registry.names() == []
