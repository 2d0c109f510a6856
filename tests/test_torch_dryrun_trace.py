"""The dry-run's traces and the model on DTensors.

* ``run_one`` on the ``fake`` backend at world 8 traces every reduced cell
  of ``tests/test_torch_dryrun.py`` (train under dense / efbv / hier /
  local, prefill and decode on a (2, 2, 2) and a (4, 2) mesh, and an MoE
  decode): each is ``ok`` with per-rank memory, and every train cell
  runs collectives (the counterpart of the reference's
  ``test_mini_dryrun_reduced_multipod``).  Subprocesses, so no process
  group leaks into other tests.
* ``launch.train --dry-run`` hands over to the dry-run and its record is
  written (a full-width cell that traces in seconds).
* Numerics on DTensors: on a 4-rank ``gloo`` (2, 2) group, the loss and
  gradients of reduced danube, qwen1.5-4b and mamba2 with the rules'
  placements (FSDP + tensor parallel, the activation and gradient hooks
  installed) equal the single-process port's within atol 1e-5 (f32): the
  model's DTensor paths (``local_map`` attention, SSD scan and embedding,
  the vocab-parallel loss, the row statistics) move no value.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dryrun import CELLS, MESHES, SHAPES  # noqa: E402

N_PROCS = 3
ATOL = 1e-5

TRACE_SIDE = """
import json, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr

MESHES, SHAPES = {meshes!r}, {shapes!r}
dr.init_fake_group(8)
meshes = {{k: init_device_mesh("cpu", tuple(d), mesh_dim_names=tuple(n))
          for k, (d, n) in MESHES.items()}}
out = {{}}
for arch, mesh_name, kind in {cells!r}:
    k = kind if kind in ("prefill", "decode") else "train"
    rec = dr.run_one(arch, k, mesh_name == "2x2x2", "dense" if k != "train" else kind,
                     mesh=meshes[mesh_name], cfg=get_config(arch).reduced(),
                     shape=InputShape(k, *SHAPES[k], k))
    rec.pop("traceback", None)
    out["|".join((arch, mesh_name, kind))] = rec
print(json.dumps(out))
"""


def _popen(path, code):
    path.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(path.parent))


def _wait(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    procs = [_popen(tmp / f"trace{i}.py",
                    TRACE_SIDE.format(src=os.path.join(ROOT, "src"), meshes=MESHES,
                                      shapes=SHAPES, cells=CELLS[i::N_PROCS]))
             for i in range(N_PROCS)]
    out = {}
    for p in procs:
        out.update(_wait(p))
    return out


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_run_one_traces_every_reduced_cell(traces, cell):
    rec = traces["|".join(cell)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "x".join(str(n) for n in MESHES[cell[1]][0])
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == mem["peak_bytes"] - mem["argument_size_in_bytes"]
    assert rec["trace_s"] > 0 and "compile_s" not in rec
    if cell[2] not in ("prefill", "decode"):
        assert sum(rec["collectives"].values()) > 0
        assert rec["host_state"]["key"] == 8


def test_train_cli_hands_the_dry_run_over(tmp_path):
    """``launch.train --dry-run`` execs ``launch.dryrun`` with its shape,
    mesh and sync; the record lands under ``results/dryrun`` of the working
    directory (full-width mamba2-2.7b at long_500k on the (16, 16) mesh)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "mamba2-2.7b", "--dry-run", "--shape", "long_500k"],
                       capture_output=True, text=True, env=env, cwd=str(tmp_path),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "results" / "dryrun"
                      / "mamba2-2.7b__long_500k__sp__dense.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["collectives"]


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen1.5-4b", "mamba2-2.7b"])
def test_loss_and_grads_on_a_4_rank_gloo_mesh_equal_one_process(tmp_path, arch):
    """danube: one kv head (each rank picks its q heads' kv head); qwen: kv
    heads sharded with the q heads, QKV bias; mamba2: the SSD scan on
    local shards, the tied embedding."""
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import numpy as np
        import torch
        import torch.distributed as dist
        import torch.multiprocessing as mp
        torch.set_num_threads(1)
        OUT = {str(tmp_path)!r}

        def rank_main(rank, store):
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import distribute_tensor
            from torch.distributed.tensor.experimental import implicit_replication
            from repro_torch import models as tm
            from repro_torch.configs import get_config
            from repro_torch.sharding import context as ctx, rules
            from repro_torch.utils.tree import tree_flatten, tree_unflatten
            dist.init_process_group("gloo", init_method=store, rank=rank, world_size=4)
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            cfg = get_config({arch!r}).reduced()
            params = tm.init_params(0, cfg, device="cpu")
            rng = np.random.default_rng(0)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48), dtype=np.int32))
            batch = {{"tokens": tok, "targets": torch.roll(tok, -1, 1)}}

            def loss_and_grads(p, b):
                leaves, td = tree_flatten(p)
                req = [x.detach().requires_grad_(True) for x in leaves]
                loss, _ = tm.loss_fn(tree_unflatten(td, req), cfg, b, remat="full")
                grads = torch.autograd.grad(loss, req)
                return loss, ctx.constrain_grads(tree_unflatten(td, list(grads)))

            want_loss, want = loss_and_grads(params, batch)
            specs = rules.param_specs(params, mesh, extra_leading=1, fsdp_axes=("data",))
            dparams = rules.map_with_specs(
                lambda p, s: distribute_tensor(p, mesh, rules.placements(s, mesh)), params, specs)
            bspecs = rules.batch_specs(batch, mesh)
            dbatch = {{k: distribute_tensor(v, mesh, rules.placements(bspecs[k], mesh))
                      for k, v in batch.items()}}
            ctx.set_grad_specs(specs, mesh)
            ctx.set_named_specs({{"act": ("data", None, "model")}}, mesh)
            try:
                with implicit_replication():
                    loss, grads = loss_and_grads(dparams, dbatch)
                    loss = loss.full_tensor()
                    got = [g.full_tensor() for g in tree_flatten(grads)[0]]
                    pl = [[str(x) for x in g.placements] for g in tree_flatten(grads)[0]]
                    want_pl = [[str(x) for x in p.placements] for p in tree_flatten(dparams)[0]]
            finally:
                ctx.set_grad_specs(None)
                ctx.set_named_specs(None)
            res = {{"loss": [float(loss), float(want_loss)],
                   "grad_err": max(float((g - w).abs().max())
                                   for g, w in zip(got, tree_flatten(want)[0])),
                   "grad_scale": max(float(w.abs().max()) for w in tree_flatten(want)[0]),
                   "placements": pl == want_pl}}
            with open(os.path.join(OUT, f"rank{{rank}}.json"), "w") as f:
                json.dump(res, f)
            dist.destroy_process_group()

        if __name__ == "__main__":
            store = "file://" + os.path.join(OUT, "store")
            mp.spawn(rank_main, args=(store,), nprocs=4, join=True)
            print(json.dumps([json.load(open(os.path.join(OUT, f"rank{{r}}.json")))
                              for r in range(4)]))
    """))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for res in json.loads(r.stdout.strip().splitlines()[-1]):
        got, want = res["loss"]
        assert abs(got - want) <= ATOL, res
        assert res["grad_err"] <= ATOL, res
        assert res["grad_scale"] > 1e-3              # the gradients are not all zero
        assert res["placements"]                    # each grad takes its param's placements
