"""The data-parallel EF-BV sync, ``core.ef_bv.efbv_sync_worker``, over a
4-rank ``gloo`` group (each rank one worker, spawned by a subprocess; the
store is a ``file://`` under ``tmp_path``, never a fixed port).

Tolerance: none.  Under ``qsgd`` (the runtime's last-dim blocked variant,
stochastic: the JAX package's draws injected per rank and leaf) and
``top_k``, every rank's (g_est, new h_i, new h_bar) equals, bit for bit:

* ``core.distributed.efbv_sync``'s per-leaf path with G = 4 on the stacked
  gradients and the same draws, in this process;
* the reference's ``efbv_sync_worker`` under ``shard_map`` on 4 forced host
  devices (a subprocess, as ``tests/test_sharding_multidev.py`` runs them).
  XLA's psum over the 4 devices and the port's ``all_gather`` then
  ``group_mean`` give the same bits on these inputs.

The worker leaves its inputs unchanged, and every rank's h_bar is the same.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SyncConfig
from repro_torch.core import distributed as tdist

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(6, 10), (2, 3, 256), (512,)]          # leaf order: a, c/w, n
WORLD = 4
COMPRESSORS = ("qsgd", "top_k")


def _tree(leaves):
    return {"a": leaves[0], "c": {"w": leaves[1]}, "n": leaves[2]}


def _run(path, code, env_extra=None, timeout=300):
    path.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env_extra or {}))
    r = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                       env=env, cwd=str(path.parent), timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _scalings(name):
    return tdist.sync_params(SyncConfig(mode="efbv", compressor=name), WORLD)


JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import distributed as jdist
from repro.core import ef_bv as jef

OUT, SHAPES, SCALINGS = sys.argv[1], {shapes!r}, {scalings!r}
rng = np.random.default_rng(0)
g = [rng.standard_normal((4,) + s).astype(np.float32) * rng.uniform(0.5, 3) for s in SHAPES]
h = [(rng.standard_normal((4,) + s) * 0.1).astype(np.float32) for s in SHAPES]
hb = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
tree = lambda l: {{"a": l[0], "c": {{"w": l[1]}}, "n": l[2]}}
mesh = Mesh(np.array(jax.devices()), ("w",))
keys = jax.random.split(jax.random.PRNGKey(3), 4)
arrays = {{}}
for i, s in enumerate(SHAPES):
    arrays[f"g{{i}}"], arrays[f"h{{i}}"], arrays[f"hb{{i}}"] = g[i], h[i], hb[i]
for name, (lam, nu) in SCALINGS.items():
    c = jdist.make_sync_compressor(name, 0.1, 8)

    def worker(k, g_, h_, hb_):
        sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
        ex = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)
        out = jef.efbv_sync_worker(k[0], sq(g_), sq(h_), hb_, c, lam, nu, "w")
        return tuple(ex(t) for t in out)

    f = jax.shard_map(worker, mesh=mesh, in_specs=(P("w"), P("w"), P("w"), P()),
                      out_specs=(P("w"), P("w"), P("w")))
    ge, nh, nhb = (jax.tree_util.tree_leaves(t) for t in f(keys, tree(g), tree(h), tree(hb)))
    for i, s in enumerate(SHAPES):
        arrays[f"{{name}}_ge{{i}}"] = np.asarray(ge[i])
        arrays[f"{{name}}_nh{{i}}"] = np.asarray(nh[i])
        arrays[f"{{name}}_nhb{{i}}"] = np.asarray(nhb[i])
        if name == "qsgd":     # the draws qsgd_sharded makes from each rank's leaf key
            y = s[:-1] + (s[-1] // 256, 256) if s[-1] % 256 == 0 else s
            arrays[f"u{{i}}"] = np.stack([np.asarray(jax.random.uniform(
                jax.random.split(keys[r], len(SHAPES))[i], y)) for r in range(4)])
np.savez(os.path.join(OUT, "jax.npz"), **arrays)
print("ok")
"""

PORT_SIDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT, SHAPES, SCALINGS = sys.argv[1], {shapes!r}, {scalings!r}


def rank_main(rank, store):
    torch.set_num_threads(1)
    from repro_torch.core import distributed as tdist
    from repro_torch.core.ef_bv import efbv_sync_worker
    from repro_torch.utils.tree import tree_flatten
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=4)
    z = np.load(os.path.join(OUT, "jax.npz"))
    tree = lambda l: {{"a": l[0], "c": {{"w": l[1]}}, "n": l[2]}}
    leaf = lambda k, i: torch.from_numpy(z[f"{{k}}{{i}}"][rank].copy())
    n = len(SHAPES)
    g = tree([leaf("g", i) for i in range(n)])
    h = tree([leaf("h", i) for i in range(n)])
    hb = tree([torch.from_numpy(z[f"hb{{i}}"].copy()) for i in range(n)])
    before = [t.clone() for t in tree_flatten((g, h, hb))[0]]
    arrays = {{}}
    for name, (lam, nu) in SCALINGS.items():
        c = tdist.make_sync_compressor(name, 0.1, 8)
        noise = [leaf("u", i) for i in range(n)] if name == "qsgd" else None
        out = efbv_sync_worker(g, h, hb, c, lam, nu, noise=noise)
        for key, t in zip(("ge", "nh", "nhb"), out):
            for i, a in enumerate(tree_flatten(t)[0]):
                arrays[f"{{name}}_{{key}}{{i}}"] = a.numpy()
    unchanged = all(torch.equal(a, b) for a, b in zip(before, tree_flatten((g, h, hb))[0]))
    np.savez(os.path.join(OUT, f"rank{{rank}}.npz"), unchanged=unchanged, **arrays)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=("file://" + os.path.join(OUT, "store"),), nprocs=4, join=True)
    print("ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference under shard_map, then the port's 4 gloo ranks on
    the same inputs and draws -> (jax arrays, [rank arrays])."""
    out = tmp_path_factory.mktemp("dp")
    fmt = dict(shapes=SHAPES, scalings={n: _scalings(n) for n in COMPRESSORS})
    _run(out / "jax_side.py", textwrap.dedent(JAX_SIDE).format(**fmt).replace(
        "sys.argv[1]", repr(str(out))), env_extra={"JAX_PLATFORMS": "cpu"})
    _run(out / "port_side.py", textwrap.dedent(PORT_SIDE).format(**fmt).replace(
        "sys.argv[1]", repr(str(out))))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(np.load(out / "jax.npz")), ranks


def _bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", COMPRESSORS)
def test_worker_equals_the_stacked_sync(runs, name):
    """Rank r's results == ``efbv_sync``'s per-leaf path over G = 4 stacked
    workers (group r), bit for bit; h_bar is the same on every rank."""
    z, ranks = runs
    n = len(SHAPES)
    lam, nu = _scalings(name)
    g = _tree([torch.from_numpy(z[f"g{i}"].copy()) for i in range(n)])
    state = tdist.SyncState(h=_tree([torch.from_numpy(z[f"h{i}"].copy()) for i in range(n)]),
                            h_bar=_tree([torch.from_numpy(z[f"hb{i}"].copy()) for i in range(n)]),
                            step=0)
    noise = ([[torch.from_numpy(z[f"u{i}"][r].copy()) for r in range(WORLD)] for i in range(n)]
             if name == "qsgd" else None)
    c = tdist.make_sync_compressor(name, 0.1, 8)
    g_est, state = tdist.efbv_sync(g, state, c, lam, nu, bucket_size=0, noise=noise)
    want_ge = [g_est["a"], g_est["c"]["w"], g_est["n"]]
    want_h = [state.h["a"], state.h["c"]["w"], state.h["n"]]
    want_hb = [state.h_bar["a"], state.h_bar["c"]["w"], state.h_bar["n"]]
    for r, got in enumerate(ranks):
        assert bool(got["unchanged"])
        for i in range(n):
            assert _bits(got[f"{name}_ge{i}"], want_ge[i].numpy()), (r, i)
            assert _bits(got[f"{name}_nh{i}"], want_h[i][r].numpy()), (r, i)
            assert _bits(got[f"{name}_nhb{i}"], want_hb[i].numpy()), (r, i)


@pytest.mark.parametrize("name", COMPRESSORS)
def test_worker_equals_the_reference_under_shard_map(runs, name):
    """Rank r's results == the reference worker r's under ``shard_map``
    (psum over 4 host devices), bit for bit."""
    z, ranks = runs
    for r, got in enumerate(ranks):
        for i in range(len(SHAPES)):
            for key in ("ge", "nh", "nhb"):
                want = z[f"{name}_{key}{i}"][r]
                assert _bits(got[f"{name}_{key}{i}"], want), (r, i, key)
    # the sync did something: h moved, and g_est is not h_bar
    assert not np.array_equal(ranks[0][f"{name}_nh0"], z["h0"][0])
