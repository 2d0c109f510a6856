"""The dry-run's inputs against the reference's (``repro_torch.launch.specs``
and ``.dryrun`` vs ``repro.launch.specs`` and ``.dryrun``).

* ``INPUT_SHAPES``, ``skip_reason`` and ``input_specs`` for the ten configs
  at full width (``meta`` tensors: nothing is allocated), decode caches
  leaf by leaf; ``auto_grad_accum`` and ``_serving_fsdp`` exactly.
* For reduced configs on a (2, 2, 2) and a (4, 2) mesh: every input leaf's
  DTensor placements equal the placements of the reference's
  ``compiled.input_shardings`` (its ``build_*_lowering`` compiled on an
  Auto-axis mesh of 8 forced host devices, in subprocesses, as
  ``tests/test_sharding_multidev.py`` runs them), and the port's argument
  bytes per rank plus the leaves it keeps on the host (step counters, the
  PRNG key, the cache position, named in the record's ``host_state``)
  equal XLA's ``argument_size_in_bytes`` exactly.  The port's side runs on
  the ``fake`` backend at world 8, in a subprocess (no process group leaks
  into other tests).
* Reduced dbrx (MoE) is among the parity cells under ``dense`` train
  (the expert-parallel ``moe_ffn_shardmap``) and prefill on both meshes.
  MoE train and prefill cells trace ``ok`` through ``moe_ffn_shardmap``
  (Queue 1, item 8d), and through the scatter dispatch under the
  ``scatter`` override; reduced llama4 (its 16 experts kept) at
  ``train_4k`` on the fake 512-rank (2, 16, 16) production mesh is ``ok``
  with all-gathers and all-reduces, and with all-to-alls under the
  ``moe_a2a`` perf variant's ``alltoall`` override.  A ``qsgd_kernel`` efbv dry-run traces B1
  through its registered fake op and never its plain version.  The
  ``MemTracker`` peak of a fake step equals the real CPU run's.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import specs as tspecs
from repro_torch.sharding import rules

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(list_configs())     # the JAX package's: the port held to its
PARITY_ARCHS = ("qwen1.5-4b", "h2o-danube-1.8b", "mamba2-2.7b", "seamless-m4t-large-v2")
MOE_ARCH = "dbrx-132b"
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")), "4x2": ((4, 2), ("data", "model"))}
# hier's replicas live on the "pod" axis, which only the multi-pod mesh has
KINDS = {"2x2x2": ("dense", "efbv", "hier", "local", "prefill", "decode"),
         "4x2": ("dense", "efbv", "local", "prefill", "decode")}
CELLS = ([(a, m, k) for a in PARITY_ARCHS for m in MESHES for k in KINDS[m]]
         + [(MOE_ARCH, m, k) for m in MESHES for k in ("dense", "prefill", "decode")])
A2A_ARCH = "llama4-scout-17b-a16e"
SHAPES = {"train": (32, 8), "prefill": (32, 8), "decode": (64, 8)}
# the reference's input leaves the port keeps on the host, by its path
HOST_LEAVES = {"state.opt_state.step": "opt_state/step",
               "state.sync_state.step": "sync_state/step",
               "state.key": "key", "cache.pos": "cache/pos"}
N_REF_PROCS = 3


REF_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from types import SimpleNamespace
sys.path.insert(0, {src!r})
import jax
from jax.sharding import AxisType
from repro.configs import get_config, list_configs
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.launch import dryrun as dr
from repro.sharding import rules

MESHES, SHAPES = {meshes!r}, {shapes!r}


def keystr(path):
    out = []
    for k in path:
        out.append(str(k.key) if hasattr(k, "key") else str(k.name) if hasattr(k, "name")
                   else f"[{{k.idx}}]")
    return ".".join(out)


def spec_of(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]


out = {{"cells": {{}}}}
for arch, mesh_name, kind in {cells!r}:
    cfg = get_config(arch).reduced()
    dims, names = MESHES[mesh_name]
    mesh = jax.make_mesh(tuple(dims), tuple(names), axis_types=(AxisType.Auto,) * len(dims))
    k = kind if kind in ("prefill", "decode") else "train"
    shape = InputShape(k, *SHAPES[k], k)
    if kind == "prefill":
        low, args = dr.build_prefill_lowering(cfg, mesh, shape), ("params", "batch")
    elif kind == "decode":
        low, args = dr.build_decode_lowering(cfg, mesh, shape), ("params", "token", "cache")
    else:
        low, args = dr.build_train_lowering(cfg, mesh, shape, kind), ("state", "batch")
    comp = low.compile()
    leaves = {{}}
    for name, tree in zip(args, comp.input_shardings[0]):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            leaves[(name + "." + keystr(path)).rstrip(".")] = spec_of(s)
    out["cells"]["|".join((arch, mesh_name, kind))] = {{
        "leaves": leaves, "arg_bytes": int(comp.memory_analysis().argument_size_in_bytes)}}
if {table!r}:
    accum, fsdp = {{}}, {{}}
    for arch in list_configs():
        cfg = get_config(arch)
        for sname, shape in INPUT_SHAPES.items():
            for n in (16, 32, 256, 512):
                for w in (16, 1):
                    accum[f"{{arch}}|{{sname}}|{{n}}|{{w}}"] = dr.auto_grad_accum(cfg, shape, n, w)
        for mp in (False, True):
            names = ("pod", "data", "model") if mp else ("data", "model")
            m = SimpleNamespace(shape=dict(zip(names, (2, 16, 16) if mp else (16, 16))),
                                axis_names=names)
            got = dr._serving_fsdp(cfg, m)
            fsdp[f"{{arch}}|{{mp}}"] = None if got is None else list(got)
    out["accum"], out["fsdp"] = accum, fsdp
print(json.dumps(out))
"""

PORT_SIDE = """
import json, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun as dr
from repro_torch.sharding import context as ctx

MESHES, SHAPES = {meshes!r}, {shapes!r}
dr.init_fake_group(8)
meshes = {{k: init_device_mesh("cpu", tuple(d), mesh_dim_names=tuple(n))
          for k, (d, n) in MESHES.items()}}


def shape_of(kind):
    k = kind if kind in ("prefill", "decode") else "train"
    return InputShape(k, *SHAPES[k], k)


def build(cfg, mesh, kind, compressor="qsgd"):
    shape = shape_of(kind)
    if kind == "prefill":
        return dr.build_prefill_step(cfg, mesh, shape)
    if kind == "decode":
        return dr.build_decode_step(cfg, mesh, shape)
    return dr.build_train_step(cfg, mesh, shape, kind, compressor)


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + "." + str(k))
    else:
        yield prefix, tree


out = {{"cells": {{}}}}
for arch, mesh_name, kind in {cells!r}:
    with FakeTensorMode():
        step = build(get_config(arch).reduced(), meshes[mesh_name], kind)
        leaves = {{}}
        for name, tree in step.inputs.items():
            for path, t in flat(tree, name):
                loc = t.to_local()
                leaves[path] = ([str(p) for p in t.placements],
                                loc.numel() * loc.element_size())
        out["cells"]["|".join((arch, mesh_name, kind))] = {{
            "leaves": leaves, "arg_bytes": dr.nbytes(step.inputs), "host": step.host,
            "dtensors": all(isinstance(t, DTensor) for _, t in
                        (x for n, tr in step.inputs.items() for x in flat(tr, n)))}}
    for f in (ctx.set_grad_specs, ctx.set_named_specs, ctx.set_moe_specs):
        f(None)

# MoE train / prefill through the expert-parallel dispatch, and the scatter
# override
moe = get_config("{moe}").reduced()
mesh = meshes["2x2x2"]
out["moe"] = {{k: dr.run_one("{moe}", k, False, "dense", mesh=mesh, cfg=moe,
                            shape=shape_of(k)) for k in ("dense", "prefill")}}
ctx.set_moe_impl_override("scatter")
try:
    out["moe_scatter"] = dr.run_one("{moe}", "dense", False, "dense", mesh=mesh, cfg=moe,
                                    shape=shape_of("dense"))
finally:
    ctx.set_moe_impl_override(None)

# qsgd_kernel efbv: B1 through its fake, never the plain version
class Count(TorchDispatchMode):
    n = 0
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro.quant_dequant_2d.default:
            Count.n += 1
        return func(*args, **(kwargs or {{}}))

def refuse(*a, **k):
    raise AssertionError("the plain B1 ran under the dry-run")

kref.quant_dequant_ref = refuse
with FakeTensorMode():
    step = build(get_config("h2o-danube-1.8b").reduced(), meshes["4x2"], "efbv",
                 "qsgd_kernel")
    with Count():
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            step.run()
out["b1_fake_calls"] = Count.n
for f in (ctx.set_grad_specs, ctx.set_named_specs, ctx.set_moe_specs):
    f(None)

# reduced llama4 (with the full config's 16 experts: alltoall needs E to
# divide over "model") at train_4k on the fake 512-rank production mesh,
# then under the alltoall override (the moe_a2a variant)
from dataclasses import replace
a2a = get_config("{a2a}").reduced()
a2a = replace(a2a, moe=replace(a2a.moe, num_experts=get_config("{a2a}").moe.num_experts))
out["prod"] = {{"shardmap": dr.run_one("{a2a}", "train_4k", True, cfg=a2a)}}
ctx.set_moe_impl_override("alltoall")
try:
    out["prod"]["alltoall"] = dr.run_one("{a2a}", "train_4k", True, cfg=a2a)
finally:
    ctx.set_moe_impl_override(None)
print(json.dumps(out, default=str))
"""


def _run(tmp, name, code, env_extra=None):
    path = tmp / name
    path.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env_extra or {}))
    return subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp))


def _wait(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The reference's compiled cells (split over N_REF_PROCS processes, the
    first also computing the accumulation / FSDP table) and the port's, all
    started together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(ROOT, "src")
    fmt = dict(src=src, meshes=MESHES, shapes=SHAPES)
    refs = [_run(tmp, f"ref{i}.py", REF_SIDE.format(cells=CELLS[i::N_REF_PROCS],
                                                    table=i == 0, **fmt),
                 {"JAX_PLATFORMS": "cpu"})
            for i in range(N_REF_PROCS)]
    port = _run(tmp, "port.py", PORT_SIDE.format(cells=CELLS, moe=MOE_ARCH, a2a=A2A_ARCH, **fmt))
    ref = {"cells": {}}
    for i, p in enumerate(refs):
        got = _wait(p)
        ref["cells"].update(got["cells"])
        if i == 0:
            ref["accum"], ref["fsdp"] = got["accum"], got["fsdp"]
    return ref, _wait(port)


# ---------------------------------------------------------------------------
# Shapes, specs and the accumulation table (in this process)
# ---------------------------------------------------------------------------
def test_input_shapes_and_skip_reasons_equal_the_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in INPUT_SHAPES.items()} \
        == {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in J_SHAPES.items()}
    for arch in ARCHS:
        for sname in INPUT_SHAPES:
            assert tspecs.skip_reason(get_config(arch), sname) \
                == jspecs.skip_reason(jget_config(arch), sname), (arch, sname)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference_at_full_width(arch):
    """Every shape's specs, decode caches leaf by leaf, as meta tensors.  The
    reference's int32 ``cache["pos"]`` is a host int in the port."""
    for sname in INPUT_SHAPES:
        got = dict(_leaves(tspecs.input_specs(get_config(arch), sname)))
        want = dict(_leaves(jspecs.input_specs(jget_config(arch), sname)))
        want.pop("/cache/pos", None)
        assert sorted(got) == sorted(want), (arch, sname)
        for path, t in got.items():
            w = want[path]
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(w.shape), (arch, sname, path)
            assert str(t.dtype).split(".")[-1] == np.dtype(w.dtype).name, (arch, sname, path)


def test_auto_grad_accum_and_serving_fsdp_equal_the_reference(sides):
    ref, _ = sides
    for key, want in ref["accum"].items():
        arch, sname, n, w = key.split("|")
        assert tdr.auto_grad_accum(get_config(arch), INPUT_SHAPES[sname], int(n),
                                   int(w)) == want, key
    for key, want in ref["fsdp"].items():
        arch, mp = key.split("|")
        mesh = SimpleNamespace(
            shape=dict(zip(("pod", "data", "model"), (2, 16, 16))) if mp == "True"
            else {"data": 16, "model": 16},
            axis_names=("pod", "data", "model") if mp == "True" else ("data", "model"))
        got = tdr._serving_fsdp(get_config(arch), mesh)
        assert (None if got is None else list(got)) == want, key


@pytest.mark.parametrize("no_tp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_specs_take_the_reference_accumulation(sides, multi_pod, no_tp, monkeypatch):
    """``train_specs``' choice of ``grad_accum`` (dense: the data ranks, or
    every rank under ``NO_TP``) is the reference's, at full width."""
    ref, _ = sides
    monkeypatch.setattr(rules, "NO_TP", no_tp)
    dims = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = SimpleNamespace(shape=dict(zip(names, dims)), axis_names=names)
    n = 32 if multi_pod else 16
    key_n, w = (n * 16, 1) if no_tp else (n, 16)
    for arch in ARCHS:
        tc = tdr.train_specs(get_config(arch), mesh, INPUT_SHAPES["train_4k"])[0]
        assert tc.grad_accum == ref["accum"][f"{arch}|train_4k|{key_n}|{w}"], arch


# ---------------------------------------------------------------------------
# Placements and argument bytes against XLA's (subprocesses)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_placements_and_argument_bytes_equal_the_reference(sides, cell):
    ref, port = sides
    key = "|".join(cell)
    want, got = ref["cells"][key], port["cells"][key]
    dims, names = MESHES[cell[1]]
    mesh = SimpleNamespace(shape=dict(zip(names, dims)), axis_names=names)
    assert got["dtensors"]                  # every input a DTensor
    mapped, host = {}, {}
    for path, spec in want["leaves"].items():
        if path in HOST_LEAVES:
            host[HOST_LEAVES[path]] = spec
            continue
        path = (path.replace("state.opt_state.mu.", "state.mu.")
                .replace("state.opt_state.nu.", "state.nu.")
                .replace("state.sync_state.h.", "state.h.")
                .replace("state.sync_state.h_bar.", "state.h_bar."))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        mapped[path] = [str(p) for p in rules.placements(spec, mesh)]
    # XLA drops the inputs a step never reads (jit's keep_unused=False): the
    # encoder's weights in an encoder-decoder decode, whose cache holds
    # the encoder memory
    unread = sorted(set(got["leaves"]) - set(mapped))
    assert all(cell[2] == "decode" and p.startswith("params.encoder.") for p in unread), unread
    assert set(mapped) <= set(got["leaves"]), key
    for path, pl in mapped.items():
        assert got["leaves"][path][0] == pl, (key, path)
    assert sorted(host) == sorted(got["host"]), key
    assert got["arg_bytes"] == sum(b for _, b in got["leaves"].values())
    read = got["arg_bytes"] - sum(got["leaves"][p][1] for p in unread)
    assert read + sum(got["host"].values()) == want["arg_bytes"], key


def test_moe_train_and_prefill_are_not_ported(sides):
    """Were ``not_ported`` until Queue 1, item 8d: now every MoE train and
    prefill cell traces ``ok`` through the expert-parallel dispatch (whose
    token gather and combine are an all-gather and an all-reduce), and
    under the scatter override."""
    _, port = sides
    for kind, rec in port["moe"].items():
        assert rec["status"] == "ok", (kind, rec.get("error"))
        assert rec["collectives"].get("all_gather_into_tensor", 0) > 0, (kind, rec)
        assert rec["collectives"].get("all_reduce", 0) > 0, (kind, rec)
    scatter = port["moe_scatter"]
    assert scatter["status"] == "ok", scatter.get("error")
    assert sum(scatter["collectives"].values()) > 0


@pytest.mark.parametrize("impl", ["shardmap", "alltoall"])
def test_moe_train_4k_on_the_fake_512_rank_mesh(sides, impl):
    _, port = sides
    rec = port["prod"][impl]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "2x16x16"
    counts = rec["collectives"]
    assert counts.get("all_gather_into_tensor", 0) > 0 and counts.get("all_reduce", 0) > 0
    assert (counts.get("all_to_all_single", 0) > 0) == (impl == "alltoall"), counts


def test_qsgd_kernel_dry_run_traces_b1_through_its_fake(sides):
    """The efbv step's sync under ``qsgd_kernel`` dispatches the B1 op (one
    call per 512-wide chunk group of each leaf) to its fake; the plain
    version, replaced by one that raises, is never called."""
    _, port = sides
    assert port["b1_fake_calls"] > 0


@pytest.mark.parametrize("kind,seq", [("train", 256), ("prefill", 512)])
def test_memtracker_peak_of_a_fake_step_equals_the_real_run(kind, seq):
    """Reduced danube, one device: ``MemTracker``'s peak under
    ``FakeTensorMode`` (what the dry-run records) equals its peak over the
    same step run on real CPU tensors."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = get_config("h2o-danube-1.8b").reduced()
    shape = InputShape(kind, seq, 2, kind)
    est = tdr.trace_step(lambda: tdr.build_single_step(cfg, shape, device="cpu"))
    step = tdr.build_single_step(cfg, shape, device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in tdr.local_tensors(step.inputs):
        if t.is_floating_point():
            t.normal_(0, 0.02, generator=g)
        else:
            t.random_(0, cfg.vocab_size, generator=g)
    mt = MemTracker()
    mt.track_external(*tdr.local_tensors(step.inputs))
    with mt:
        step.run()
    real = mt.get_tracker_snapshot("peak")
    assert est["memory"]["argument_size_in_bytes"] == tdr.nbytes(step.inputs)
    assert est["memory"]["peak_bytes"] == max(v["Total"] for v in real.values())
    assert est["collectives"] == {}
