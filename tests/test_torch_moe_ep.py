"""The expert-parallel MoE paths (``models.moe.moe_ffn_shardmap``, with and
without ``gather_quant``, and ``moe_ffn_alltoall``) on 8 ``gloo`` ranks of
a (2, 4) ("data", "model") mesh, each rank a spawned process (the store a
``file://`` under the test's temporary directory, never a port), at
``tests/test_sharding_multidev.py``'s sizes: E = 4 experts, d = 64,
ff = 128, x (4, 16, 64) f32, capacity factor E / K (no drops).  Two
settings: top-2 gated, and top-1 gated with a shared expert.

* Forward, against the port's scatter ``moe_ffn`` on one process: shardmap
  within rel 1e-4 of the max (the reference's bound), alltoall within
  rel 1e-5 in norm (the reference's bound); gather_quant (int8 tokens)
  within rel 2e-2 of the max (the quantization).
* Forward, against the reference's own ``moe_ffn_shardmap`` and
  ``moe_ffn_alltoall`` (jitted on an Auto-axis mesh of 8 forced host
  devices in a subprocess, as ``tests/test_torch_dryrun.py`` runs the
  reference) on the same parameters, carried across by ``interop``:
  f32 outputs within 1e-5 of their max (the outputs reach ~270); under
  gather_quant plus one bf16 rounding of the combine (its ``psum`` runs in
  bf16, and the backends may add the four ranks' terms in their own
  orders).  The aux loss equals the reference's per-data-shard ``pmean``
  within 1e-6 (not the scatter path's global statistic).
* Gradients of ``sum(y * R)`` for x, the router and the experts, against
  the scatter path's on one process: within 1e-5 of each gradient's max
  (float order only); 2e-2 under gather_quant, whose tokens' gradient
  (through the scales only) is left out.  With K = 1 the renormalized gate
  is 1, so the router's gradient from y is rounding noise in both paths
  (3.6e-4 against 3.6e2 for x): it is held through the aux loss instead.
  The aux loss's router gradient, against the per-shard mean computed on
  one process: within 1e-5 of its max, 2e-2 under gather_quant (each
  "model" rank computes it alike, and only the lead rank's copy feeds
  back).
* Every rank's output equals every other's; shardmap's output is whole
  over "model", alltoall's d-sharded.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
E, D, FF = 4, 64, 128
X_SHAPE = (4, 16, D)
SETTINGS = {"top2": dict(top_k=2, shared_expert=False),
            "top1_shared": dict(top_k=1, shared_expert=True)}
PATHS = ("shardmap", "shardmap_quant", "alltoall")
WAIT_S = 600

REF_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, {src!r})
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import moe as moe_lib

E, D, FF, X_SHAPE, SETTINGS = {e!r}, {d!r}, {ff!r}, {x_shape!r}, {settings!r}
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {{}}
for si, (name, st) in enumerate(sorted(SETTINGS.items())):
    K = st["top_k"]
    params = moe_lib.init_moe(jax.random.PRNGKey(si), D, FF, E, True, st["shared_expert"],
                              jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(10 + si), X_SHAPE)
    kw = dict(num_experts=E, top_k=K, capacity_factor=float(E) / K, act="silu", gated=True,
              shared_expert=st["shared_expert"])
    y, aux = moe_lib.moe_ffn(params, x, **kw)
    runs = {{"shardmap": lambda p, x: moe_lib.moe_ffn_shardmap(
                p, x, mesh=mesh, data_axes=("data",), **kw),
            "shardmap_quant": lambda p, x: moe_lib.moe_ffn_shardmap(
                p, x, mesh=mesh, data_axes=("data",), gather_quant=True, **kw),
            "alltoall": lambda p, x: moe_lib.moe_ffn_alltoall(
                p, x, mesh=mesh, data_axes=("data",), **kw)}}
    for path, fn in runs.items():
        with mesh:
            yp, auxp = jax.jit(fn)(params, x)
        out[f"{{name}}|{{path}}|y"] = np.asarray(yp)
        out[f"{{name}}|{{path}}|aux"] = np.asarray(auxp)
    out[f"{{name}}|x"] = np.asarray(x)
    out[f"{{name}}|scatter|aux"] = np.asarray(aux)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{{name}}|p|" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
np.savez(os.path.join({out!r}, "ref.npz"), **out)
print("ok")
"""

RANKS = """
import json, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT, E, SETTINGS, PATHS = {out!r}, {e!r}, {settings!r}, {paths!r}


def params_of(z, name):
    tree = {{}}
    for k in z.files:
        if k.startswith(name + "|p|"):
            node = tree
            parts = k.split("|p|", 1)[1].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = torch.from_numpy(z[k].copy())
    return tree


def flat(tree, pre=""):
    out = {{}}
    for k, v in tree.items():
        out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {{pre + k: v}})
    return out


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def shard_aux(params, x, kw, path):
    # the reference's aux: each data shard's Switch statistic, then the mean
    from repro_torch.models import moe
    K = kw["top_k"]
    vals = []
    for xs in x.chunk(2, 0):
        xt = xs.reshape(-1, xs.shape[-1])
        if path == "alltoall":      # the psum of four partial logits
            parts = [xt[:, i * 16:(i + 1) * 16].float() @ params["router"][i * 16:(i + 1) * 16]
                     for i in range(4)]
            r = moe.route_logits(((parts[0] + parts[1]) + parts[2]) + parts[3], E, K,
                                 kw["capacity_factor"])
        else:
            r = moe.route(params["router"], xt, E, K, kw["capacity_factor"])
        vals.append(moe._aux_loss(r, E, K))
    return (vals[0] + vals[1]) / 2


def case(rank, z, name, st, mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe

    K = st["top_k"]
    kw = dict(num_experts=E, top_k=K, capacity_factor=float(E) / K, act="silu", gated=True,
              shared_expert=st["shared_expert"])
    params = params_of(z, name)
    x = torch.from_numpy(z[name + "|x"].copy())
    R = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    # the scatter path on one process, and its gradients
    leaves = flat(params)
    req = {{k: v.clone().requires_grad_(True) for k, v in leaves.items()}}
    xr = x.clone().requires_grad_(True)

    def tree_of(d):
        t = {{}}
        for k, v in d.items():
            node = t
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = v
        return t

    y_ref, _ = moe.moe_ffn(tree_of(req), xr, **kw)
    g_ref = torch.autograd.grad((y_ref * R).sum(), [xr] + list(req.values()))
    res = {{}}
    for path in PATHS:
        place = {{"router": [Replicate(), Replicate()], "w_in": [Replicate(), Shard(0)],
                 "w_gate": [Replicate(), Shard(0)], "w_out": [Replicate(), Shard(0)],
                 "shared/w_in": [Replicate(), Shard(1)], "shared/w_gate": [Replicate(), Shard(1)],
                 "shared/w_out": [Replicate(), Shard(0)]}}
        dparams = {{k: distribute_tensor(v, mesh, place[k], src_data_rank=None).requires_grad_(True)
                   for k, v in leaves.items()}}
        xd = distribute_tensor(x, mesh, [Shard(0), Shard(2)], src_data_rank=None)
        xd.requires_grad_(True)
        fn = moe.moe_ffn_alltoall if path == "alltoall" else moe.moe_ffn_shardmap
        extra = {{"gather_quant": True}} if path == "shardmap_quant" else {{}}
        with implicit_replication():
            y, aux = fn(tree_of(dparams), xd, **kw, **extra)
            yf = y.full_tensor()
            grads = torch.autograd.grad((y * R).sum(), [xd] + list(dparams.values()),
                                        retain_graph=True)
            grads = [g.full_tensor() for g in grads]
            agrads = torch.autograd.grad(aux, [dparams["router"]], allow_unused=True)
        want_aux_p = {{k: v.clone().requires_grad_(True) for k, v in leaves.items()}}
        want_aux = shard_aux(tree_of(want_aux_p), x, kw, path)
        want_ag = torch.autograd.grad(want_aux, [want_aux_p["router"]])[0]
        got_ag = agrads[0].full_tensor() if agrads[0] is not None else torch.zeros_like(want_ag)
        yj = torch.from_numpy(z[f"{{name}}|{{path}}|y"])
        res[path] = {{
            "rel_max": rel(yf.detach(), y_ref.detach()),
            "rel_norm": float((yf.detach() - y_ref.detach()).norm() / y_ref.detach().norm()),
            "jax_err": float((yf.detach() - yj).abs().max()),
            "jax_scale": float(yj.abs().max()),
            "aux": float(aux.full_tensor()), "aux_jax": float(z[f"{{name}}|{{path}}|aux"]),
            "grad_err": [rel(g, w) if path != "shardmap_quant" or i > 0 else 0.0
                         for i, (g, w) in enumerate(zip(grads, g_ref))],
            "grad_names": ["x"] + list(leaves),
            "grad_scale": [float(w.abs().max()) for w in g_ref],
            "aux_grad_err": rel(got_ag, want_ag),
            "y_placements": [[type(p).__name__, getattr(p, "dim", None)] for p in y.placements],
        }}
    return res


def rank_main(rank, store):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    z = np.load(os.path.join(OUT, "ref.npz"))
    res = {{name: case(rank, z, name, st, mesh) for name, st in sorted(SETTINGS.items())}}
    with open(os.path.join(OUT, f"rank{{rank}}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=("file://" + os.path.join(OUT, "store"),), nprocs=8, join=True)
    print(json.dumps([json.load(open(os.path.join(OUT, f"rank{{r}}.json"))) for r in range(8)]))
"""


def _run(path, code, env_extra=None):
    path.write_text(code)
    env = dict(os.environ, PYTHONPATH=SRC, **(env_extra or {}))
    proc = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                          env=env, cwd=str(path.parent), timeout=WAIT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's outputs first (the ranks read its parameters), then
    one spawn of 8 ranks for every case."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    fmt = dict(src=SRC, out=str(tmp), e=E, settings=SETTINGS)
    _run(tmp / "ref_side.py", textwrap.dedent(REF_SIDE).format(d=D, ff=FF, x_shape=X_SHAPE, **fmt),
         {"JAX_PLATFORMS": "cpu"})
    return json.loads(_run(tmp / "ranks.py", textwrap.dedent(RANKS).format(paths=PATHS, **fmt)))


CASES = [(s, p) for s in sorted(SETTINGS) for p in PATHS]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_forward_against_the_scatter_path(ranks, case):
    name, path = case
    for rank, res in enumerate(ranks):
        got = res[name][path]
        if path == "shardmap":
            assert got["rel_max"] < 1e-4, (rank, got)
        elif path == "alltoall":
            assert got["rel_norm"] < 1e-5, (rank, got)
        else:
            assert got["rel_max"] < 2e-2, (rank, got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_forward_against_the_reference(ranks, case):
    name, path = case
    for rank, res in enumerate(ranks):
        got = res[name][path]
        tol = (1e-5 + (2.0 ** -8 if path == "shardmap_quant" else 0.0)) * got["jax_scale"]
        assert got["jax_err"] <= tol, (rank, got)
        assert abs(got["aux"] - got["aux_jax"]) <= 1e-6, (rank, got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_gradients_against_the_scatter_path(ranks, case):
    """Under gather_quant the tokens' gradient is the reference's (through
    the scales only: ``round`` and the int8 cast carry none), so x is left
    out there; the weights' gradients are the scatter path's within the
    quantization."""
    name, path = case
    tol = 2e-2 if path == "shardmap_quant" else 1e-5
    for rank, res in enumerate(ranks):
        got = res[name][path]
        for gname, e in zip(got["grad_names"], got["grad_err"]):
            if gname == "router" and SETTINGS[name]["top_k"] == 1:
                continue
            assert e <= tol, (rank, gname, got)
        assert got["aux_grad_err"] <= tol, (rank, got)


@pytest.mark.parametrize("path", PATHS)
def test_ranks_agree_and_placements(ranks, path):
    for name in SETTINGS:
        first = ranks[0][name][path]
        for res in ranks[1:]:
            assert res[name][path]["jax_err"] == first["jax_err"]
            assert res[name][path]["aux"] == first["aux"]
    # shardmap's output is whole over "model", alltoall's d-sharded (the
    # shared expert's row-parallel output makes a sum partial over "model")
    want = ["Replicate", None] if path.startswith("shardmap") else ["Shard", 2]
    assert ranks[0]["top2"][path]["y_placements"] == [["Shard", 0], want]
