"""The costing (Queue 1, item 8c): ``repro_torch.launch.{hlo_analysis,
costing,perf}`` and ``comm.ledger.crosscheck_hlo`` against the reference's
``repro.launch.{hlo_analysis,costing,perf}`` and ``repro.comm.ledger``.

1. The payload rules: the reference's ``collective_bytes`` over a synthetic
   post-SPMD HLO text (every kind, explicit and iota ``replica_groups``, a
   transposed iota and an explicit group across the pod boundary, an async
   ``-done`` line) equals the port's ``CollectiveStats`` over the
   equivalent records exactly, ``inter_pod_bytes`` included.
2. ``corrected_costs``' arithmetic: the reference's ``_lower_variant`` and
   the port's ``_trace_variant`` patched, inside the test, to return the
   same A and B (decode shapes, so the reference's C is None too): equal
   results, for a dense, a hybrid (8-layer period) and an encoder-decoder
   config.
3. ``comm_time_model`` bit for bit for ``Topology`` and ``TreeTopology``
   presets, with ``tile_bytes > 0`` and with an enabled ``FaultConfig``.
4. ``model_flops`` for all ten configs x ``INPUT_SHAPES``.
5. ``crosscheck_hlo``: the same dict for the same ledger and stats.
6. ``apply_variants`` / ``reset_variants`` set and restore the same flags
   as the reference's for each of the eight variants.
7. In a subprocess on the ``fake`` group at world 8, a (4, 2) mesh: the
   extrapolated flops and collective bytes of reduced h2o-danube-1.8b and
   reduced mamba2-2.7b (4 layers each; dense and efbv train, prefill) equal
   a direct full-depth trace's exactly (flops are whole numbers: the
   tolerance is 0).  So do a prefill's unfused bytes; a train step's are
   not affine in the depth: each period's ``select`` of the stacked params
   has a ``select_backward`` that writes a whole stacked-size gradient, and
   autograd adds them up, so those bytes grow with the square of the period
   count; the extrapolation is held within 5% of the direct trace.  On one
   device, ``CostCounter``'s flops equal ``FlopCounterMode``'s over the
   same fake step; a collective count by kind equals ``CommDebugMode``'s;
   ``perf.measure`` of reduced danube gives a record with the reference's
   keys.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs      # the JAX package's architectures
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

HLO_TEXT = """
HloModule step
ENTRY %main {
  %ar = f32[1024,256] all-reduce(f32[1024,256] %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,512] all-gather(bf16[16,512] %y), replica_groups=[64,4]<=[256], dimensions={0}
  %rs = f32[256] reduce-scatter(f32[1024] %z), replica_groups={{0,256},{1,257}}, dimensions={0}
  %a2a = bf16[16,32,64] all-to-all(bf16[16,32,64] %w), replica_groups=[128,4]<=[512], dimensions={0}
  %cp = f32[8,8] collective-permute(f32[8,8] %v), source_target_pairs={{0,1},{1,0}}
  %ar2 = bf16[4096] all-reduce(bf16[4096] %u), replica_groups=[256,2]<=[2,256]T(1,0), to_apply=%add
  %ags = bf16[32,128] all-gather-start(bf16[8,128] %t), replica_groups={{0,1,2,3}}, dimensions={0}
  %agd = bf16[32,128] all-gather-done(bf16[32,128] %ags)
}
"""
# the same collectives as (kind, result bytes, the group's global ranks)
RECORDS = [
    ("all-reduce", 1024 * 256 * 4, [0, 1, 2, 3]),
    ("all-gather", 64 * 512 * 2, [0, 1, 2, 3]),
    ("reduce-scatter", 256 * 4, [0, 256]),
    ("all-to-all", 16 * 32 * 64 * 2, [0, 1, 2, 3]),
    ("collective-permute", 8 * 8 * 4, [0]),
    ("all-reduce", 4096 * 2, [0, 256]),
    ("all-gather", 32 * 128 * 2, [0, 1, 2, 3]),
]


def test_collective_payload_rules_equal_the_reference():
    from repro.launch import hlo_analysis as jhlo
    from repro_torch.launch import hlo_analysis as thlo
    want = jhlo.collective_bytes(HLO_TEXT)
    got = thlo.collective_bytes(RECORDS)
    assert got.as_dict() == want.as_dict()
    assert want.inter_pod_bytes > 0 and len(want.count_by_kind) == 5
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_corrected_costs_arithmetic_equals_the_reference(arch, monkeypatch):
    from repro.launch import costing as jc
    from repro_torch.launch import costing as tc

    def fake(n_periods):
        base = {"flops": 1.5e12, "bytes": 3.25e11, "coll_total": 7.0e9,
                "coll_interpod": 1.0e9, "coll_all-reduce": 4.0e9, "coll_all-gather": 3.0e9}
        return {k: v * (1.0 + 0.75 * (n_periods - 1)) + 17.0 for k, v in base.items()}

    monkeypatch.setattr(jc, "_lower_variant", lambda cfg, mesh, shape, kind, n, bk, sync,
                        builders: fake(n))
    monkeypatch.setattr(tc, "_trace_variant", lambda cfg, mesh, shape, n, sync, device=None:
                        fake(n))
    for shape in ("decode_32k", "long_500k"):
        want = jc.corrected_costs(jget_config(arch), None, shape)
        got = tc.corrected_costs(get_config(arch), None, shape)
        assert want["variants"]["C"] is None
        assert got == want, (arch, shape)


def _fault_pair():
    from repro.faults.model import FaultConfig as JF
    from repro_torch.faults.model import FaultConfig as TF
    kw = dict(seed=3, availability=0.9, straggler_rate=0.1, straggler_sigma=0.5,
              drop_rate=0.05, delay_rate=0.1, delay_s=0.02, deadline_s=2.0)
    return JF(**kw), TF(**kw)


@pytest.mark.parametrize("preset", ["v5p_superpod", "geo_wan", "edge_fl", "v5p_superpod_tree",
                                    "geo_wan_tree", "edge_fl_tree"])
def test_comm_time_model_equals_the_reference(preset):
    from repro.comm.topology import get_topology as jtopo
    from repro.comm.tree import get_tree_topology as jtree
    from repro.launch import costing as jc
    from repro_torch.comm.topology import get_topology as ttopo
    from repro_torch.comm.tree import get_tree_topology as ttree
    from repro_torch.launch import costing as tc

    j = jtree(preset) if preset.endswith("_tree") else jtopo(preset)
    t = ttree(preset) if preset.endswith("_tree") else ttopo(preset)
    jf, tf = _fault_pair()
    measures = {"coll_total": 1.234567e9, "coll_interpod": 2.5e8}
    for kw_j, kw_t in (({}, {}), ({"tile_bytes": 1 << 20}, {"tile_bytes": 1 << 20}),
                       ({"tile_bytes": 1 << 20, "faults": jf},
                        {"tile_bytes": 1 << 20, "faults": tf})):
        want = jc.comm_time_model(measures, topology=j, **kw_j)
        got = tc.comm_time_model(measures, topology=t, **kw_t)
        assert got == want, (preset, kw_t)
    assert "t_comm_degraded_s" in got and "t_comm_stream_s" in got
    # the default topology
    assert tc.comm_time_model(measures) == jc.comm_time_model(measures)


def test_model_flops_equal_the_reference():
    from repro.launch import costing as jc
    from repro_torch.launch import costing as tc
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    for arch in list_configs():
        for shape in INPUT_SHAPES:
            assert tc.model_flops(get_config(arch), shape) == \
                jc.model_flops(jget_config(arch), shape), (arch, shape)


def test_crosscheck_hlo_equals_the_reference():
    from repro.comm.ledger import CommLedger as JL
    from repro.comm.ledger import crosscheck_hlo as jcross
    from repro.launch import hlo_analysis as jhlo
    from repro_torch.comm.ledger import CommLedger as TL
    from repro_torch.comm.ledger import crosscheck_hlo as tcross
    from repro_torch.launch import hlo_analysis as thlo

    jstats, tstats = jhlo.collective_bytes(HLO_TEXT), thlo.collective_bytes(RECORDS)
    for total in (int(jstats.total_bytes), 123_456, 0):
        jl, tl = JL(), TL()
        for led in (jl, tl):
            if total:
                led.record(0, "pod0->root", total - total // 3, tag="quant")
                led.record(0, "pod1->root", total // 3, tag="quant")
        for tol in (0.25, 0.01):
            assert tcross(tl, tstats, rel_tol=tol) == jcross(jl, jstats, rel_tol=tol)
    assert tcross(TL(), thlo.CollectiveStats())["consistent"] is False


def _reference_perf(monkeypatch):
    """Import the reference's perf module without its device-count flag
    (``setdefault`` keeps a value that is already there)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import perf as jperf
    return jperf


def _flags():
    from repro.models import attention as jattn
    from repro.sharding import context as jctx
    from repro.sharding import rules as jrules
    from repro_torch.models import attention as tattn
    from repro_torch.sharding import context as tctx
    from repro_torch.sharding import rules as trules
    named_j = {k: tuple(v.spec) for k, v in (jctx._NAMED_SPECS or {}).items()}
    named_t = {k: s for k, (s, _) in tctx.named_specs_state().items()}
    return ((jattn.BANDED, jrules.NO_TP, jctx.get_moe_impl_override(),
             jctx.get_moe_gather_quant(), named_j),
            (tattn.BANDED, trules.NO_TP, tctx.get_moe_impl_override(),
             tctx.get_moe_gather_quant(), named_t))


@pytest.mark.parametrize("variant", ["banded", "ssd_heads", "sync_hier", "sync_efbv",
                                     "moe_quant", "moe_a2a", "no_tp", "accum2x"])
def test_apply_and_reset_variants_equal_the_reference(variant, monkeypatch):
    import jax
    from jax.sharding import AxisType
    from repro_torch.launch import perf as tperf
    jperf = _reference_perf(monkeypatch)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    tmesh = SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))
    before = _flags()
    for arch in ("mamba2-2.7b", "h2o-danube-1.8b"):
        try:
            want = jperf.apply_variants([variant], jmesh, jget_config(arch))
            got = tperf.apply_variants([variant], tmesh, get_config(arch))
            assert got == want, (variant, arch)
            j, t = _flags()
            assert t == j, (variant, arch)
        finally:
            jperf.reset_variants()
            tperf.reset_variants()
        assert _flags() == before
    assert before[0] == before[1]


EXTRAPOLATION = """
import json, sys
sys.path.insert(0, {src!r})
from dataclasses import replace
import torch
torch.set_num_threads(1)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import costing, dryrun as dr, perf

out = {{}}
# one device: the counter against FlopCounterMode on the same fake step
cfg = get_config("h2o-danube-1.8b").reduced()
shape = InputShape("train", 64, 2, "train")
rec = dr.trace_step(lambda: dr.build_single_step(cfg, shape, device="cpu"), cost=True)
with FakeTensorMode(allow_non_fake_inputs=True):
    step = dr.build_single_step(cfg, shape, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step.run()
out["single"] = [rec["cost"]["flops"], fc.get_total_flops()]
cc = costing.corrected_costs(replace(cfg, num_layers=4), None, shape)
direct = dr.trace_step(lambda: dr.build_single_step(replace(cfg, num_layers=4), shape,
                                                    device="cpu"), cost=True)
out["single_extrapolated"] = [cc["corrected"]["flops"], direct["cost"]["flops"]]

dr.init_fake_group(8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
for arch, kind, sync in {cases!r}:
    cfg = replace(get_config(arch).reduced(), num_layers=4)
    shape = InputShape(kind, 64, 8, kind)
    cc = costing.corrected_costs(cfg, mesh, shape, sync_mode=sync, device="cpu")
    if kind == "train":
        build = lambda: dr.build_train_step(cfg, mesh, shape, sync, grad_accum=1, device="cpu")
    else:
        build = lambda: dr.build_prefill_step(cfg, mesh, shape, device="cpu")
    rec = dr.trace_step(build, cost=True)
    out["|".join((arch, kind, sync))] = {{
        "corrected": cc["corrected"], "direct": costing._measures(rec),
        "A": cc["variants"]["A"], "n_periods": cc["n_periods"],
        "counts": rec["collective_stats"]["counts"], "comm_debug": rec["collectives"]}}
rec = perf.measure("h2o-danube-1.8b", "train_4k", [], cfg=get_config("h2o-danube-1.8b").reduced())
out["perf"] = rec
print(json.dumps(out))
"""
CASES = [("h2o-danube-1.8b", "train", "dense"), ("h2o-danube-1.8b", "train", "efbv"),
         ("mamba2-2.7b", "train", "dense"), ("mamba2-2.7b", "prefill", "dense")]
# CommDebugMode's op names -> the reference's kinds
DEBUG_KINDS = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


@pytest.fixture(scope="module")
def extrapolation(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("costing")
    path = tmp / "extrapolation.py"
    path.write_text(textwrap.dedent(EXTRAPOLATION).format(src=SRC, cases=CASES))
    proc = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=SRC), cwd=str(tmp), timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_counter_flops_equal_flop_counter_mode(extrapolation):
    got, want = extrapolation["single"]
    assert got == want > 0
    got, want = extrapolation["single_extrapolated"]
    assert got == want > 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_extrapolated_costs_equal_a_full_depth_trace(extrapolation, case):
    got = extrapolation["|".join(case)]
    assert got["n_periods"] == 4
    assert sorted(got["corrected"]) == sorted(got["direct"])
    for key, want in got["direct"].items():
        if key == "bytes" and case[1] == "train":
            assert abs(got["corrected"][key] - want) <= 0.05 * want, (case, got)
            continue
        assert got["corrected"][key] == want, (case, key, got["corrected"], got["direct"])
    # one period is less than the whole: the extrapolation did something
    assert got["A"]["flops"] < got["direct"]["flops"]
    assert got["direct"]["coll_total"] > 0
    # every collective CommDebugMode saw is counted under its kind
    kinds = {}
    for op, n in got["comm_debug"].items():
        kinds[DEBUG_KINDS[op]] = kinds.get(DEBUG_KINDS[op], 0) + n
    assert kinds == got["counts"], got


def test_perf_record_keys(extrapolation):
    rec = extrapolation["perf"]
    for k in ("arch", "shape", "variants", "sync", "mesh", "terms_s", "dominant",
              "useful_ratio", "mem_gb", "trace_s", "coll_total", "coll_interpod"):
        assert k in rec, k
    assert rec["mesh"] == "16x16" and rec["sync"] == "dense"
    assert sorted(rec["terms_s"]) == ["collective_s", "compute_s", "interpod_s", "memory_s"]
    assert all(v > 0 for k, v in rec["terms_s"].items() if k != "interpod_s")
    assert rec["terms_s"]["interpod_s"] == 0.0          # one pod
