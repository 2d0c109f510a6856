"""Values of the dry-run's DTensor programs on a 4-rank ``gloo`` group
(each rank a spawned process; the store a ``file://`` under the test's
temporary directory, never a port).

* The per-rank train steps, ``make_train_step(..., mesh=)``, laid out and
  hooked by ``launch.dryrun.build_train_step``, take two steps of reduced
  h2o-danube-1.8b from the single-process state; params, AdamW moments, h,
  h_bar and the losses equal the single-process ``efbv_step`` /
  ``local_step``'s (per-leaf sync, ``bucket_size=0``) within atol 1e-5.
  The stochastic ``rand_k`` runs where "model" has size 1 with the
  single-process draws replayed; the tensor- and FSDP-sharded layouts run
  ``identity`` (a rank compresses each leaf whole, which
  ``tests/test_torch_tp_compress.py`` holds on split leaves with ``qsgd``
  and ``top_k``).  Both are continuous in the gradient: the sharded loss and
  norms sum in another order than one process, and a quantizer's rounding
  would turn those float-level differences into whole levels.  Both runs
  use plain SGD (AdamW's normalized step would do the same to near-zero
  gradients).  hier / local use a sync period of 2 (no sync, then a
  sync).
* ``core.ef_bv.param_sync_worker`` on 4 ranks equals the reference's
  ``hier_param_sync`` (JAX, per leaf, its own draws replayed) within atol
  1e-5, and the port's ``hier_param_sync`` on the stacked replicas bit for
  bit.
* ``make_decode_step`` on DTensor params and caches (``build_decode_step``'s
  layout on a (2, 2) mesh: batch over "data"; the attention cache's slot
  axis, the SSD heads and conv channels, the experts over "model") takes
  two decode steps of reduced danube (a write into each slot shard),
  mamba2 and dbrx (MoE); logits and caches equal the plain decode's within
  atol 1e-5.
* The dry-run's per-rank peak: ``trace_step`` of danube's dense and efbv
  steps on the (2, 2) mesh, run for real on each gloo rank, gives the same
  argument bytes and collective counts as its fake trace on a 4-rank
  ``fake`` group (what the dry-run records), and a ``MemTracker`` peak
  within 5% of it (equal on an idle host).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as tdist

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ATOL = 1e-5
ARCH = "h2o-danube-1.8b"
# (mode, mesh dims, mesh axes, compressor)
TRAIN_CASES = [
    ("efbv", (4, 1), ("data", "model"), "rand_k"),
    ("efbv", (2, 2), ("data", "model"), "identity"),
    ("local", (4, 1), ("data", "model"), "rand_k"),
    ("local", (2, 2), ("data", "model"), "identity"),
    ("hier", (4, 1, 1), ("pod", "data", "model"), "rand_k"),
    ("hier", (2, 2, 1), ("pod", "data", "model"), "identity"),
]
DECODE_ARCHS = ("h2o-danube-1.8b", "mamba2-2.7b", "dbrx-132b")
MEM_MODES = ("dense", "efbv")
SYNC_SHAPES = [(6, 10), (2, 3, 256), (512,)]     # param_sync_worker's leaves
SYNC_LAM = 0.5
SYNC_COMPRESSORS = ("qsgd", "top_k")

COMMON = """
import json, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
OUT = {out!r}


def blocked(shape):
    # the draw shape of the sharded qsgd (blocks of 256 along the last axis)
    shape = tuple(shape)
    return shape[:-1] + (shape[-1] // 256, 256) if shape and shape[-1] % 256 == 0 else shape


def fill(dt, full):
    # a DTensor's local shard <- its part of the whole tensor ``full``
    from torch.distributed.tensor import distribute_tensor
    dt.to_local().copy_(distribute_tensor(full, dt.device_mesh, dt.placements,
                                          src_data_rank=None).to_local())


def err(dt, full):
    return float((dt.full_tensor().float() - full.float()).abs().max())
"""

JAX_SIDE = """
import jax, jax.numpy as jnp
from repro.core import distributed as jdist

SHAPES, LAM = {shapes!r}, {lam!r}
rng = np.random.default_rng(0)
p = [rng.standard_normal((4,) + s).astype(np.float32) for s in SHAPES]
hb = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
tree = lambda l: {{"a": l[0], "c": {{"w": l[1]}}, "n": l[2]}}
key = jax.random.PRNGKey(5)
arrays = {{f"p{{i}}": p[i] for i in range(len(SHAPES))}}
arrays.update({{f"hb{{i}}": hb[i] for i in range(len(SHAPES))}})
for name in {compressors!r}:
    c = jdist.make_sync_compressor(name, 0.1, 8)
    state = jdist.SyncState(h=(), h_bar=tree([jnp.asarray(x) for x in hb]), step=jnp.int32(0))
    new_p, new_state = jdist.hier_param_sync(key, tree([jnp.asarray(x) for x in p]), state, c,
                                             LAM, 1, bucket_size=0)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(new_p),
                                   jax.tree_util.tree_leaves(new_state.h_bar))):
        arrays[f"{{name}}_p{{i}}"], arrays[f"{{name}}_hb{{i}}"] = np.asarray(a), np.asarray(b)
# the per-leaf draws: leaf li's key folded into the level's, split over the replicas
lkey = jdist._level_key(key, 0, 1)
for i, s in enumerate(SHAPES):
    keys = jax.random.split(jax.random.fold_in(lkey, i), 4)
    arrays[f"u{{i}}"] = np.stack([np.asarray(jax.random.uniform(keys[r], blocked(s)))
                                 for r in range(4)])
np.savez(os.path.join(OUT, "jax.npz"), **arrays)
print("ok")
"""

FAKE_SIDE = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr

dr.init_fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_config({arch!r}).reduced()
out = {{}}
for mode in {modes!r}:
    rec = dr.trace_step(lambda: dr.build_train_step(
        cfg, mesh, InputShape("train", 32, 8, "train"), mode, "qsgd", device="cpu"))
    out[mode] = {{"memory": rec["memory"], "collectives": rec["collectives"]}}
print(json.dumps(out))
"""

SPAWN = """
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=4)
    res = run(rank)
    with open(os.path.join(OUT, f"{{NAME}}{{rank}}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=("file://" + os.path.join(OUT, NAME + "_store"),), nprocs=4,
             join=True)
    print(json.dumps([json.load(open(os.path.join(OUT, f"{{NAME}}{{r}}.json")))
                      for r in range(4)]))
"""

TRAIN_SIDE = """
NAME = "train"
ARCH, CASES, MEM_MODES = {arch!r}, {cases!r}, {mem_modes!r}
SHAPES, LAM, COMPRESSORS = {shapes!r}, {lam!r}, {compressors!r}
SEQ, BATCH, STEPS = 16, 8, 2


def trees(st):
    out = {{"params": st.params}}
    if st.sync_state.h != ():
        out["h"] = st.sync_state.h
    out["h_bar"] = st.sync_state.h_bar
    return out


def train_case(mode, dims, names, comp):
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.training import steps as steps_lib

    # plain SGD in both runs (AdamW's normalized step turns float-order
    # differences in near-zero gradients into lr-sized ones)
    adamw = steps_lib._make_optimizer
    steps_lib._make_optimizer = lambda tc: make_optimizer(
        "sgd", cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps))
    try:
        return _train_case(mode, dims, names, comp)
    finally:
        steps_lib._make_optimizer = adamw


def _train_case(mode, dims, names, comp):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, SyncConfig, TrainConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.sharding import context as ctx
    from repro_torch.training.steps import init_train_state, make_train_step
    from repro_torch.utils.device import make_generator
    from repro_torch.utils.tree import tree_flatten

    cfg = get_config(ARCH).reduced()
    sizes = dict(zip(names, dims))
    n_groups, n_pods = sizes.get("pod", 1) * sizes["data"], sizes.get("pod", 1)
    G = n_pods if mode == "hier" else n_groups
    period = 1 if mode == "efbv" else 2
    tc = TrainConfig(model=cfg, seq_len=SEQ, global_batch=BATCH, lr=0.2, warmup_steps=1,
                     total_steps=10, remat="full", grad_accum=1,
                     sync=SyncConfig(mode=mode, compressor=comp, sync_period=period,
                                     bucket_size=0))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32))
        batches.append({{"tokens": tok, "targets": torch.roll(tok, -1, 1)}})
    shapes = [p.shape for p in tree_flatten(tm.init_params(0, cfg, device="meta"))[0]]
    # rand_k's draws: one score per coordinate of the flattened leaf
    noises = [[[torch.from_numpy(rng.random(int(np.prod(s)), dtype=np.float32))
                for _ in range(G)] for s in shapes] if comp == "rand_k" else None
              for _ in range(STEPS)]

    # one process
    st = init_train_state(make_generator(0, "cpu"), tm.init_params(0, cfg, device="cpu"), tc,
                          n_groups, n_pods)
    init = {{k: [t.clone() for t in tree_flatten(v)[0]] for k, v in trees(st).items()}}
    step = make_train_step(cfg, tc, n_groups, n_pods)
    want_loss = []
    for t in range(STEPS):
        st, m = step(st, batches[t], noise=noises[t])
        want_loss.append(float(m["loss"]))
    want = {{k: tree_flatten(v)[0] for k, v in trees(st).items()}}

    # the mesh: the dry-run's layout and hooks, the step with this config
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
    built = dr.build_train_step(cfg, mesh, InputShape("train", SEQ, BATCH, "train"), mode,
                                comp, sync_period=period, device="cpu")
    dstate, dbatch = built.args
    for k, leaves in init.items():
        for dt, full in zip(tree_flatten(trees(dstate)[k])[0], leaves):
            fill(dt, full)
    dstate = dstate._replace(sync_state=dstate.sync_state._replace(step=0))
    mstep = make_train_step(cfg, tc, n_groups, n_pods, mesh=mesh)
    got_loss = []
    try:
        with implicit_replication():
            for t in range(STEPS):
                b = {{k: distribute_tensor(v, mesh, dbatch[k].placements, src_data_rank=None)
                     for k, v in batches[t].items()}}
                dstate, m = mstep(dstate, b, noise=noises[t])
                got_loss.append(float(m["loss"]))
            got = {{k: tree_flatten(v)[0] for k, v in trees(dstate).items()}}
            errs = {{k: max(err(g, w) for g, w in zip(got[k], want[k])) for k in want}}
            placed = all(g.placements == d.placements for g, d in zip(
                got["params"], tree_flatten(built.inputs["state"]["params"])[0]))
    finally:
        ctx.set_grad_specs(None)
        ctx.set_named_specs(None)
        ctx.set_moe_specs(None)
    moved = {{k: max(float((w.float() - i.float()).abs().max()) for w, i in zip(want[k], init[k]))
             for k in want}}
    return {{"loss": [got_loss, want_loss], "err": errs, "moved": moved, "placed": placed}}


def mem_real(mode):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as dr

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(ARCH).reduced()

    def build():
        s = dr.build_train_step(cfg, mesh, InputShape("train", 32, 8, "train"), mode, "qsgd",
                                device="cpu")
        for t in dr.local_tensors(s.inputs):
            t.zero_()
        return s

    rec = dr.trace_step(build, fake=False)
    return {{"memory": rec["memory"], "collectives": rec["collectives"]}}


def param_sync(rank):
    from repro_torch.core import distributed as tdist
    from repro_torch.core.ef_bv import param_sync_worker
    from repro_torch.utils.tree import tree_flatten
    z = np.load(os.path.join(OUT, "jax.npz"))
    tree = lambda l: {{"a": l[0], "c": {{"w": l[1]}}, "n": l[2]}}
    n = len(SHAPES)
    out = {{}}
    for name in COMPRESSORS:
        p = tree([torch.from_numpy(z[f"p{{i}}"][rank].copy()) for i in range(n)])
        hb = tree([torch.from_numpy(z[f"hb{{i}}"].copy()) for i in range(n)])
        hb0 = [t.clone() for t in tree_flatten(hb)[0]]
        c = tdist.make_sync_compressor(name, 0.1, 8)
        noise = ([torch.from_numpy(z[f"u{{i}}"][rank].copy()) for i in range(n)]
                 if name == "qsgd" else None)
        new_hb = param_sync_worker(p, hb, c, LAM, noise=noise)
        out[name] = {{"p": [t.tolist() for t in tree_flatten(p)[0]],
                     "hb": [t.tolist() for t in tree_flatten(new_hb)[0]],
                     "hb_unchanged": all(torch.equal(a, b)
                                         for a, b in zip(hb0, tree_flatten(hb)[0]))}}
    return out


def run(rank):
    return {{"train": {{"|".join(map(str, c)): train_case(*c) for c in CASES}},
            "mem": {{m: mem_real(m) for m in MEM_MODES}},
            "sync": param_sync(rank)}}
"""

DECODE_SIDE = """
NAME = "decode"
ARCHS = {archs!r}
SEQ, B = 64, 2


def decode_case(arch):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as dr
    from repro_torch.training.steps import make_decode_step
    from repro_torch.utils.tree import tree_flatten

    cfg = get_config(arch).reduced()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    params = tm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, SEQ - 1), dtype=np.int32))
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32))
            for _ in range(2)]
    with torch.no_grad():
        _, cache = tm.prefill(params, cfg, {{"tokens": prompt}}, cache_len=SEQ)
    built = dr.build_decode_step(cfg, mesh, InputShape("decode", SEQ, B, "decode"),
                                 device="cpu")
    dparams, dtoken, dcache = built.args
    for dt, full in zip(tree_flatten(dparams)[0], tree_flatten(params)[0]):
        fill(dt, full)
    plain_leaves = tree_flatten(cache["layers"])[0]
    mesh_leaves = tree_flatten(dcache["layers"])[0]
    assert [tuple(t.shape) for t in plain_leaves] == [tuple(t.shape) for t in mesh_leaves]
    assert cache["pos"] == dcache["pos"] == SEQ - 1
    for dt, full in zip(mesh_leaves, plain_leaves):
        fill(dt, full)
    sharded = [[str(p) for p in t.placements] for t in mesh_leaves]
    step = make_decode_step(cfg)
    logit_err, scale = [], []
    with torch.no_grad(), implicit_replication():
        for tok in toks:
            want, cache = step(params, tok, cache)
            got, dcache = built.fn(dparams, distribute_tensor(tok, mesh, dtoken.placements,
                                                              src_data_rank=None), dcache)
            logit_err.append(err(got, want))
            scale.append(float(want.float().abs().max()))
        cache_err = max(err(g, w) for g, w in zip(tree_flatten(dcache["layers"])[0],
                                                  tree_flatten(cache["layers"])[0]))
    return {{"logit_err": logit_err, "scale": scale, "cache_err": cache_err,
            "pos": [cache["pos"], dcache["pos"]], "placements": sharded}}


def run(rank):
    return {{a: decode_case(a) for a in ARCHS}}
"""


def _script(path, body, **fmt):
    code = textwrap.dedent(COMMON).format(src=SRC, out=str(path.parent))
    code += textwrap.dedent(body).format(**fmt)
    path.write_text(code)
    return path


def _popen(path, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(path.parent))


def _wait(proc, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's hier_param_sync, the fake traces and the decode ranks
    in parallel; then the train ranks (they read the reference's draws)."""
    tmp = tmp_path_factory.mktemp("mesh_steps")
    jax_p = _popen(_script(tmp / "jax_side.py", JAX_SIDE, shapes=SYNC_SHAPES, lam=SYNC_LAM,
                           compressors=SYNC_COMPRESSORS), {"JAX_PLATFORMS": "cpu"})
    fake_p = _popen(_script(tmp / "fake_side.py", FAKE_SIDE, arch=ARCH, modes=MEM_MODES))
    dec_p = _popen(_script(tmp / "decode_side.py", DECODE_SIDE + SPAWN, archs=DECODE_ARCHS))
    _wait(jax_p)
    train_p = _popen(_script(tmp / "train_side.py", TRAIN_SIDE + SPAWN, arch=ARCH,
                             cases=TRAIN_CASES, mem_modes=MEM_MODES, shapes=SYNC_SHAPES,
                             lam=SYNC_LAM, compressors=SYNC_COMPRESSORS))
    out = {"fake": json.loads(_wait(fake_p)), "decode": json.loads(_wait(dec_p)),
           "train": json.loads(_wait(train_p)), "jax": dict(np.load(tmp / "jax.npz"))}
    return out


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}"
                         f"-{c[3]}")
def test_rank_train_step_equals_the_single_process_step(runs, case):
    for rank, res in enumerate(runs["train"]):
        got = res["train"]["|".join(map(str, case))]
        got_loss, want_loss = got["loss"]
        assert np.allclose(got_loss, want_loss, rtol=0, atol=ATOL), (rank, got["loss"])
        for k, e in got["err"].items():
            assert e <= ATOL, (rank, k, got["err"])
        # the steps moved the state by more than the tolerance
        assert got["moved"]["params"] > 100 * ATOL and got["moved"]["h_bar"] > 100 * ATOL, got
        assert got["placed"]                # the params keep the dry-run's placements


def _sync_inputs(z, name):
    n = len(SYNC_SHAPES)
    tree = lambda l: {"a": l[0], "c": {"w": l[1]}, "n": l[2]}    # noqa: E731
    p = tree([torch.from_numpy(z[f"p{i}"].copy()) for i in range(n)])
    hb = tree([torch.from_numpy(z[f"hb{i}"].copy()) for i in range(n)])
    noise = ([[torch.from_numpy(z[f"u{i}"][r].copy()) for r in range(4)] for i in range(n)]
             if name == "qsgd" else None)
    return p, hb, noise


@pytest.mark.parametrize("name", SYNC_COMPRESSORS)
def test_param_sync_worker_equals_the_reference(runs, name):
    """Rank r's replica and h_bar == the reference's ``hier_param_sync``
    (per leaf, period 1) within atol 1e-5, the draws replayed."""
    z = runs["jax"]
    for rank, res in enumerate(runs["train"]):
        got = res["sync"][name]
        assert got["hb_unchanged"]
        for i in range(len(SYNC_SHAPES)):
            want_p, want_hb = z[f"{name}_p{i}"][rank], z[f"{name}_hb{i}"]
            assert np.abs(np.asarray(got["p"][i]) - want_p).max() <= ATOL, (rank, i)
            assert np.abs(np.asarray(got["hb"][i]) - want_hb).max() <= ATOL, (rank, i)
            # the sync moved h_bar, and every replica adopted it
            assert np.abs(want_hb - z[f"hb{i}"]).max() > 100 * ATOL
            assert np.array_equal(np.asarray(got["p"][i], np.float32),
                                  np.asarray(got["hb"][i], np.float32))


@pytest.mark.parametrize("name", SYNC_COMPRESSORS)
def test_param_sync_worker_equals_the_stacked_sync(runs, name):
    """Rank r's results == the port's ``hier_param_sync`` over the 4
    stacked replicas with the same draws, bit for bit."""
    p, hb, noise = _sync_inputs(runs["jax"], name)
    c = tdist.make_sync_compressor(name, 0.1, 8)
    new_p, state = tdist.hier_param_sync(p, tdist.SyncState(h=(), h_bar=hb, step=0), c,
                                         SYNC_LAM, 1, bucket_size=0, noise=noise)
    want_p = [new_p["a"], new_p["c"]["w"], new_p["n"]]
    want_hb = [state.h_bar["a"], state.h_bar["c"]["w"], state.h_bar["n"]]
    for rank, res in enumerate(runs["train"]):
        got = res["sync"][name]
        for i in range(len(SYNC_SHAPES)):
            assert torch.equal(torch.tensor(got["p"][i]), want_p[i][rank]), (rank, i)
            assert torch.equal(torch.tensor(got["hb"][i]), want_hb[i]), (rank, i)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_on_dtensor_caches_equals_the_plain_decode(runs, arch):
    for rank, res in enumerate(runs["decode"]):
        got = res[arch]
        assert max(got["logit_err"]) <= ATOL, (rank, got)
        assert got["cache_err"] <= ATOL, (rank, got)
        assert min(got["scale"]) > 1e-3
        assert got["pos"] == [65, 65]
        # the caches are sharded over both mesh axes (batch and slots /
        # heads / channels)
        assert any(p[0].startswith("S(") and p[1].startswith("S(") for p in got["placements"]), got


@pytest.mark.parametrize("mode", MEM_MODES)
def test_fake_trace_memory_equals_the_real_dtensor_run(runs, mode):
    """Each gloo rank's real ``trace_step``: arguments, output and
    collective counts == the fake trace at world 4, exactly; the
    ``MemTracker`` peak within 5% of it.  The fake group completes every
    collective at once; a real rank may hold a buffer until its collective
    completes, which moves with the host's load (seen: +262,144 B on one of
    4 ranks, under load), so the peak is equal on an idle host, not always."""
    want = runs["fake"][mode]
    for rank, res in enumerate(runs["train"]):
        got = res["mem"][mode]
        for k in ("argument_size_in_bytes", "output_size_in_bytes"):
            assert got["memory"][k] == want["memory"][k], (rank, got, want)
        assert abs(got["memory"]["peak_bytes"] - want["memory"]["peak_bytes"]) \
            <= 0.05 * want["memory"]["peak_bytes"], (rank, got, want)
        assert got["collectives"] == want["collectives"], (rank, got, want)
    assert sum(want["collectives"].values()) > 0
    assert want["memory"]["peak_bytes"] > want["memory"]["argument_size_in_bytes"]
