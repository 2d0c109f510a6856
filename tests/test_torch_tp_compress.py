"""Whole-leaf compression in the per-rank train steps, on a 4-rank ``gloo``
group (each rank a spawned process; the store a ``file://`` under the
test's temporary directory, never a port).

The reference compresses a leaf whole.  A per-rank step whose "model" axis
splits a leaf must do the same: it gathers the leaf's delta over its
group's sub-mesh, compresses it and keeps its own shard.  Compressing each
shard alone gives another result wherever the compressor looks across the
shard boundary, which these cases do on reduced h2o-danube-1.8b with
``d_ff = 768`` (its MLP leaves are split at column 384 of 768):

* ``qsgd`` (the runtime's last-axis quantizer, blocks of 256): a whole
  768-wide row has three blocks, the middle one across the boundary, and a
  384-wide shard falls back to one scale for the shard;
* ``qsgd_kernel`` (B1's plain version on the CPU): 512-wide blocks of the
  flattened leaf, which straddle the shards;
* ``top_k``: one selection over the whole leaf.

Each runs efbv and local on a (2, 2) ("data", "model") mesh and hier on a
(2, 1, 2) ("pod", "data", "model") mesh, two steps from the
single-process state, with the same uniforms in both runs: drawn by
``jax.random.uniform`` in this process (one key per step, leaf and group)
and handed to both as ``noise``.  Params, h, h_bar and the losses must
equal the single-process ``efbv_step`` / ``local_step``'s (per-leaf sync,
``bucket_size=0``) within atol 1e-5.  Both runs use plain SGD, as
``tests/test_torch_mesh_steps.py`` explains, and a loss linear in the
params, ``s(batch) * sum_l <p_l, R_l>`` (``R_l`` fixed, ``s`` the group's
mean token), whose gradient ``s * R_l`` is the same bits on a shard as on
one process.  The model's own loss sums its sharded backward in another
order, and a quantizer's rounding or top_k's selection turns last-bit
differences into whole levels or swapped coordinates (seen: one of
196,608 ``w_out`` coordinates swapped at step 2); the model's gradients on
the mesh are held by ``tests/test_torch_mesh_steps.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ATOL = 1e-5
ARCH = "h2o-danube-1.8b"
D_FF = 768
STEPS = 2
MESHES = {"efbv": ((2, 2), ("data", "model")), "local": ((2, 2), ("data", "model")),
          "hier": ((2, 1, 2), ("pod", "data", "model"))}
COMPRESSORS = ("qsgd", "qsgd_kernel", "top_k")
CASES = [(m, c) for m in MESHES for c in COMPRESSORS]

RANKS = """
import json, os, sys
sys.path.insert(0, {src!r})
from dataclasses import replace
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT, ARCH, D_FF, STEPS = {out!r}, {arch!r}, {d_ff!r}, {steps!r}
MESHES, CASES = {meshes!r}, {cases!r}


def fill(dt, full):
    from torch.distributed.tensor import distribute_tensor
    dt.to_local().copy_(distribute_tensor(full, dt.device_mesh, dt.placements,
                                          src_data_rank=None).to_local())


def err(dt, full):
    return float((dt.full_tensor().float() - full.float()).abs().max())


_R = {{}}


def linear_loss(params, cfg, batch, remat=None):
    # s(batch) * sum_l <p_l, R_l>: its gradient s * R_l has no sum in it
    from repro_torch.utils.tree import tree_flatten
    s = batch["tokens"].float().mean() / cfg.vocab_size + 0.5
    loss = 0.0
    for li, p in enumerate(tree_flatten(params)[0]):
        if li not in _R:
            gen = torch.Generator().manual_seed(100 + li)
            _R[li] = torch.randn(tuple(p.shape), generator=gen) * 0.01
        loss = loss + (p.float() * _R[li]).sum()
    loss = loss * s
    return loss, {{"ce": loss}}


def trees(st):
    out = {{"params": st.params}}
    if st.sync_state.h != ():
        out["h"] = st.sync_state.h
    out["h_bar"] = st.sync_state.h_bar
    return out


def case(mode, comp, z):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, SyncConfig, TrainConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.sharding import context as ctx
    from repro_torch.training import steps as steps_lib
    from repro_torch.utils.device import make_generator
    from repro_torch.utils.tree import tree_flatten

    dims, names = MESHES[mode]
    cfg = replace(get_config(ARCH).reduced(), d_ff=D_FF)
    sizes = dict(zip(names, dims))
    n_pods = sizes.get("pod", 1)
    n_groups = n_pods * sizes["data"]
    G = n_pods if mode == "hier" else n_groups
    period = 1 if mode == "efbv" else 2
    seq, batch = 16, 8
    tc = TrainConfig(model=cfg, seq_len=seq, global_batch=batch, lr=0.2, warmup_steps=1,
                     total_steps=10, remat="full", grad_accum=1,
                     sync=SyncConfig(mode=mode, compressor=comp, sync_period=period,
                                     bucket_size=0))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32))
        batches.append({{"tokens": tok, "targets": torch.roll(tok, -1, 1)}})
    n_leaves = len(tree_flatten(tm.init_params(0, cfg, device="meta"))[0])
    key = f"{{mode}}|{{comp}}"
    noises = [None if comp == "top_k" else
              [[torch.from_numpy(z[f"{{key}}|{{t}}|{{li}}|{{g}}"]) for g in range(G)]
               for li in range(n_leaves)] for t in range(STEPS)]

    adamw, model_loss = steps_lib._make_optimizer, steps_lib.loss_fn
    steps_lib._make_optimizer = lambda tc: make_optimizer(
        "sgd", cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps))
    steps_lib.loss_fn = linear_loss
    try:
        st = steps_lib.init_train_state(make_generator(0, "cpu"),
                                        tm.init_params(0, cfg, device="cpu"), tc,
                                        n_groups, n_pods)
        init = {{k: [t.clone() for t in tree_flatten(v)[0]] for k, v in trees(st).items()}}
        step = steps_lib.make_train_step(cfg, tc, n_groups, n_pods)
        want_loss = []
        for t in range(STEPS):
            st, m = step(st, batches[t], noise=noises[t])
            want_loss.append(float(m["loss"]))
        want = {{k: tree_flatten(v)[0] for k, v in trees(st).items()}}

        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        built = dr.build_train_step(cfg, mesh, InputShape("train", seq, batch, "train"), mode,
                                    comp, sync_period=period, device="cpu")
        dstate, dbatch = built.args
        for k, leaves in init.items():
            for dt, full in zip(tree_flatten(trees(dstate)[k])[0], leaves):
                fill(dt, full)
        dstate = dstate._replace(sync_state=dstate.sync_state._replace(step=0))
        mstep = steps_lib.make_train_step(cfg, tc, n_groups, n_pods, mesh=mesh)
        got_loss = []
        with implicit_replication():
            for t in range(STEPS):
                b = {{k: distribute_tensor(v, mesh, dbatch[k].placements, src_data_rank=None)
                     for k, v in batches[t].items()}}
                dstate, m = mstep(dstate, b, noise=noises[t])
                got_loss.append(float(m["loss"]))
            got = {{k: tree_flatten(v)[0] for k, v in trees(dstate).items()}}
            errs = {{k: max(err(g, w) for g, w in zip(got[k], want[k])) for k in want}}
        split = any(p.is_shard() and g.shape[p.dim] == D_FF
                    for g in got["params"] for p in g.placements)
    finally:
        steps_lib._make_optimizer, steps_lib.loss_fn = adamw, model_loss
        ctx.set_grad_specs(None)
        ctx.set_named_specs(None)
        ctx.set_moe_specs(None)
    moved = {{k: max(float((w.float() - i.float()).abs().max()) for w, i in zip(want[k], init[k]))
             for k in want}}
    return {{"loss": [got_loss, want_loss], "err": errs, "moved": moved, "split": split}}


def rank_main(rank, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=4)
    z = np.load(os.path.join(OUT, "draws.npz"))
    res = {{f"{{m}}|{{c}}": case(m, c, z) for m, c in CASES}}
    with open(os.path.join(OUT, f"rank{{rank}}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=("file://" + os.path.join(OUT, "store"),), nprocs=4, join=True)
    print(json.dumps([json.load(open(os.path.join(OUT, f"rank{{r}}.json"))) for r in range(4)]))
"""


def _draw_shape(comp, shape):
    """The uniforms' shape the sync compressor ``comp`` takes for a leaf."""
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.kernels.quant8 import QBLOCK
    if comp == "qsgd_kernel":
        return (tile_rows(int(np.prod(shape))), QBLOCK)
    last = shape[-1]
    return shape[:-1] + (last // 256, 256) if last % 256 == 0 else shape


def _jax_draws(path):
    """One ``jax.random.uniform`` draw per (case, step, leaf, group), keyed
    by a fold of those four indices into ``PRNGKey(7)``."""
    import jax
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_flatten

    cfg = replace(get_config(ARCH).reduced(), d_ff=D_FF)
    shapes = [tuple(p.shape) for p in tree_flatten(tm.init_params(0, cfg, device="meta"))[0]]
    arrays = {}
    base = jax.random.PRNGKey(7)
    for ci, (mode, comp) in enumerate(CASES):
        if comp == "top_k":
            continue
        dims, names = MESHES[mode]
        sizes = dict(zip(names, dims))
        G = sizes.get("pod", 1) * (1 if mode == "hier" else sizes["data"])
        for t in range(STEPS):
            for li, s in enumerate(shapes):
                for g in range(G):
                    k = base
                    for i in (ci, t, li, g):
                        k = jax.random.fold_in(k, i)
                    arrays[f"{mode}|{comp}|{t}|{li}|{g}"] = np.asarray(
                        jax.random.uniform(k, _draw_shape(comp, s)), np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_compress")
    _jax_draws(tmp / "draws.npz")
    script = tmp / "ranks.py"
    script.write_text(textwrap.dedent(RANKS).format(
        src=SRC, out=str(tmp), arch=ARCH, d_ff=D_FF, steps=STEPS, meshes=MESHES, cases=CASES))
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env=env, cwd=str(tmp), timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_rank_step_compresses_the_whole_leaf(ranks, case):
    for rank, res in enumerate(ranks):
        got = res["|".join(case)]
        assert got["split"]                 # the 768-wide leaves are split over "model"
        got_loss, want_loss = got["loss"]
        assert np.allclose(got_loss, want_loss, rtol=0, atol=ATOL), (rank, got["loss"])
        for k, e in got["err"].items():
            assert e <= ATOL, (rank, k, got["err"])
        assert got["moved"]["params"] > 100 * ATOL and got["moved"]["h_bar"] > 100 * ATOL, got
