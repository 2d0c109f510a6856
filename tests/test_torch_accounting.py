"""The port's round accounting, topology models and fault plans against the
JAX package.

Tolerance: none.  ``RoundCost`` (every field, the per-level ``LevelCost``s
included), ``round_ledger``'s bytes per tag, the ledger's modelled
``round_time_s``/``total_time_s`` and ``FaultModel.round_plan``'s survivor
masks must be equal.  The byte counts come from each package encoding its
own probe (the port draws it from a seeded generator), so they are equal
because the wire size does not depend on the probe's values; the times are
models of the named topology presets, never measurements.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import comm as tcomm
from repro_torch.configs.base import LevelConfig as TLevel
from repro_torch.configs.base import SyncConfig as TSync
from repro_torch.faults import FaultConfig as TFault
from repro_torch.faults import FaultModel as TFaultModel

torch.set_num_threads(2)

N_REDUCED = 606_848                # reduced h2o-danube-1.8b
N_FULL = 1_831_201_280             # full width: probe capped at 2^20
FLAT = ("v5p_superpod", "geo_wan", "edge_fl")
TREES = ("v5p_superpod_tree", "geo_wan_tree", "edge_fl_tree")
FAULTS = dict(seed=3, availability=0.9, straggler_rate=0.2, straggler_sigma=0.5,
              drop_rate=0.05, corrupt_rate=0.01, delay_rate=0.1, delay_s=0.02,
              deadline_s=0.5)


@pytest.fixture(scope="module")
def jx():
    from repro import comm as jcomm
    from repro.configs import base as jbase
    from repro.faults import FaultConfig, FaultModel
    return jcomm, jbase, FaultConfig, FaultModel


def _as_dict(cost):
    out = dataclasses.asdict(cost)
    out["total_bytes"], out["stream_speedup"] = cost.total_bytes, cost.stream_speedup
    return out


def _pair(jx, faults=False, levels=None, **kw):
    jbase, JFault = jx[1], jx[2]
    jlev = tlev = None
    if levels:
        jlev = tuple(jbase.LevelConfig(*lv) for lv in levels)
        tlev = tuple(TLevel(*lv) for lv in levels)
    jf = JFault(**FAULTS) if faults else None
    tf = TFault(**FAULTS) if faults else None
    return (jbase.SyncConfig(levels=jlev, faults=jf, **kw),
            TSync(levels=tlev, faults=tf, **kw))


FLAT_CASES = ([("dense", "topk_block", t) for t in FLAT] + [("local", "topk_block", t) for t in FLAT]
              + [(m, c, t) for m in ("efbv", "ef21", "diana")
                 for c in ("topk_block", "top_k", "qsgd", "qsgd_kernel", "identity") for t in FLAT[:1]]
              + [("efbv", c, t) for c in ("topk_block", "qsgd_kernel") for t in FLAT[1:]])


@pytest.mark.parametrize("mode,comp,topo", FLAT_CASES)
def test_round_cost_flat_modes_equal_jax(jx, mode, comp, topo):
    jsync, tsync = _pair(jx, mode=mode, compressor=comp, topology=topo, sync_period=4,
                         compress_ratio=0.02)
    want = jx[0].round_cost(jsync, N_REDUCED)
    got = tcomm.round_cost(tsync, N_REDUCED, device="cpu")
    assert _as_dict(got) == _as_dict(want)


@pytest.mark.parametrize("comp", ["qsgd_kernel", "topk_block", "qsgd"])
def test_round_cost_at_full_width_extrapolates_as_jax(jx, comp):
    jsync, tsync = _pair(jx, mode="efbv", compressor=comp)
    assert _as_dict(tcomm.round_cost(tsync, N_FULL, device="cpu")) == \
        _as_dict(jx[0].round_cost(jsync, N_FULL))


HIER_CASES = ([(t, None, False) for t in FLAT] + [("v5p_superpod", None, True)]
              + [(t, (("a", 1, "identity"), ("b", 2, "topk_block", 0.05), ("c", 4, "qsgd_kernel")), False)
                 for t in TREES]
              + [("edge_fl_tree", (("a", 1, "top_k", 0.1), ("b", 2, "qsgd"), ("c", 6, "identity")), True)])


@pytest.mark.parametrize("topo,levels,faults", HIER_CASES)
def test_round_cost_and_ledger_hier_equal_jax(jx, topo, levels, faults):
    jcomm = jx[0]
    jsync, tsync = _pair(jx, faults=faults, levels=levels, mode="hier", compressor="qsgd",
                         topology=topo, sync_period=3)
    want = jcomm.round_cost(jsync, N_REDUCED)
    got = tcomm.round_cost(tsync, N_REDUCED, device="cpu")
    assert _as_dict(got) == _as_dict(want)
    jled = jcomm.round_ledger(jsync, N_REDUCED, n_rounds=12)
    tled = tcomm.round_ledger(tsync, N_REDUCED, n_rounds=12, device="cpu")
    assert tled.bytes_by_tag() == jled.bytes_by_tag()
    assert [dataclasses.astuple(r) for r in tled.records] == \
        [dataclasses.astuple(r) for r in jled.records]
    jtopo = jcomm.get_topology(topo if topo in FLAT else "geo_wan")
    ttopo = tcomm.get_topology(topo if topo in FLAT else "geo_wan")
    assert tled.total_time_s(ttopo) == jled.total_time_s(jtopo)
    assert [tled.round_time_s(ttopo, t) for t in range(12)] == \
        [jled.round_time_s(jtopo, t) for t in range(12)]


def test_round_cost_with_faults_flat_and_bits_wrappers(jx):
    jcomm = jx[0]
    from repro.core import distributed as jdist
    from repro_torch.core import distributed as tdist
    jsync, tsync = _pair(jx, faults=True, mode="efbv", compressor="topk_block")
    assert _as_dict(tcomm.round_cost(tsync, N_REDUCED, device="cpu")) == \
        _as_dict(jcomm.round_cost(jsync, N_REDUCED))
    assert tdist.bits_per_round(tsync, N_REDUCED, device="cpu") == \
        jdist.bits_per_round(jsync, N_REDUCED)
    assert _as_dict(tdist.round_comm(tsync, N_REDUCED, device="cpu")) == \
        _as_dict(jdist.round_comm(jsync, N_REDUCED))


def test_topology_and_tree_presets_equal_jax(jx):
    jcomm = jx[0]
    for name in FLAT:
        jt, tt = jcomm.get_topology(name), tcomm.get_topology(name)
        for nb in (1e3, 1e6, 2.5e8):
            for scope in ("intra", "inter", "global"):
                assert tt.allreduce_time_s(nb, scope) == jt.allreduce_time_s(nb, scope)
                assert tt.allreduce_stream_time_s(nb, scope) == jt.allreduce_stream_time_s(nb, scope)
    for name in FLAT + TREES:
        jt, tt = jcomm.get_tree_topology(name), tcomm.get_tree_topology(name)
        assert [(lv.name, lv.fanout, lv.link.gbps, lv.link.latency_us, lv.profile.pack_gbps)
                for lv in tt.levels] == \
            [(lv.name, lv.fanout, lv.link.gbps, lv.link.latency_us, lv.profile.pack_gbps)
             for lv in jt.levels]
        for l in range(tt.depth):
            assert tt.level_stream_time_s(l, 3e6) == jt.level_stream_time_s(l, 3e6)
            assert tt.n_parents(l) == jt.n_parents(l) and tt.n_children(l) == jt.n_children(l)
    assert tcomm.topology.norm_ppf(0.9) == jcomm.topology.norm_ppf(0.9)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_plans_equal_jax(jx, seed):
    JFault, JModel = jx[2], jx[3]
    jtree, ttree = jx[0].get_tree_topology("edge_fl_tree"), tcomm.get_tree_topology("edge_fl_tree")
    cfg = dict(FAULTS, seed=seed)
    jm, tm = JModel(JFault(**cfg), jtree), TFaultModel(TFault(**cfg), ttree)
    for rnd in range(4):
        nbytes = [1e5, 2e5, 3e5]
        jp, tp = jm.round_plan(rnd, nbytes_by_level=nbytes), tm.round_plan(rnd, nbytes_by_level=nbytes)
        for a, b in zip(jp.survivor_masks(), tp.survivor_masks()):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert tp.stats() == jp.stats() and tp.time_s == jp.time_s
    assert TFault(**cfg).expected_transmissions(0.1) == JFault(**cfg).expected_transmissions(0.1)


def test_round_time_on_a_ledger_of_records(jx):
    jcomm = jx[0]
    jl, tl = jcomm.CommLedger(), tcomm.CommLedger()
    for led in (jl, tl):
        led.record(0, "a->b", 1000, kind="intra", phase=0)
        led.record(0, "c->b", 5000, kind="intra", phase=0)
        led.record(0, "b->root", 800, kind="inter", phase=1)
        led.record(2, "a->b", 10, kind="inter")
    jt, tt = jcomm.get_topology("geo_wan"), tcomm.get_topology("geo_wan")
    assert [tl.round_time_s(tt, r) for r in range(3)] == [jl.round_time_s(jt, r) for r in range(3)]
    assert tl.total_time_s(tt) == jl.total_time_s(jt) > 0
    assert np.isclose(tl.round_time_s(tt, 0), tt.intra.time_s(5000) + tt.inter.time_s(800))
