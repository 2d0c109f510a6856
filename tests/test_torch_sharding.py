"""The port's sharding rules, context hooks and production meshes against the
reference's ``repro.sharding`` and ``repro.launch.mesh``.

* Rules: ``param_specs`` (plain; layer-stacked with FSDP over the data axes;
  replica-stacked with ``replica_axes``), ``opt_state_specs``,
  ``batch_specs`` and ``cache_pspecs`` equal the reference's specs, entry
  for entry as tuples, for all ten configs at full size on shape-only
  meshes of (16, 16) and (2, 16, 16): the JAX trees under
  ``jax.eval_shape``, the port's on ``meta``.  One case with ``NO_TP`` set.
* ``placements`` turns a spec into DTensor placements.
* The production meshes on the ``fake`` process-group backend at world size
  256 and 512, in a subprocess (no process group leaks into other tests);
  the rules on that ``DeviceMesh`` equal them on the shape-only mesh.
* ``constrain_grads`` / ``constrain_moe`` / ``constrain_named`` on a 4-rank
  ``gloo`` group (a subprocess spawning the ranks, a ``file://`` store
  under ``tmp_path``).
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.sharding import context as tctx
from repro_torch.sharding import rules as trules
from repro_torch.utils.tree import tree_map

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": SimpleNamespace(shape={"data": 16, "model": 16},
                                   axis_names=("data", "model")),
          "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                     axis_names=("pod", "data", "model"))}
ARCHS = sorted(list_configs())


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import get_config
    from repro.models import cache_specs, init_params
    from repro.sharding import rules as jrules
    return jax, PartitionSpec, get_config, init_params, cache_specs, jrules


def _flat_port(tree, prefix=""):
    """{path: spec tuple} of a port spec tree (dicts of tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _flat_ref(jax, P, tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v)
            for path, v in leaves}


def _stack(jax, tree, n):
    return jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape, s.dtype), tree)


def _spec_sets(arch, mesh, jx):
    """{case: (reference {path: spec}, port {path: spec})} for one config."""
    jax, P, get_config, init_params, cache_specs, jrules = jx
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jp = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    tp = tm.init_params(0, tcfg, device="meta")
    daxes = jrules.data_axes(mesh)
    assert trules.data_axes(mesh) == daxes
    rep = daxes[0] if len(daxes) == 1 else daxes
    jstack = _stack(jax, jp, 2)
    tstack = tree_map(lambda t: t.expand((2,) + tuple(t.shape)), tp)
    out = {}

    def both(name, ref, port):
        out[name] = (_flat_ref(jax, P, ref), _flat_port(port))

    both("plain", jrules.param_specs(jp, mesh), trules.param_specs(tp, mesh))
    jf = jrules.param_specs(jp, mesh, extra_leading=1, fsdp_axes=daxes)
    tf = trules.param_specs(tp, mesh, extra_leading=1, fsdp_axes=daxes)
    both("fsdp", jf, tf)
    both("replica", jrules.param_specs(jstack, mesh, extra_leading=2, replica_axes=rep,
                                       fsdp_axes=("data",)),
         trules.param_specs(tstack, mesh, extra_leading=2, replica_axes=rep,
                            fsdp_axes=("data",)))
    both("opt", jrules.opt_state_specs(jp, jf, mesh), trules.opt_state_specs(tp, tf, mesh))
    both("opt_nozero", jrules.opt_state_specs(jp, jf, mesh, zero1=False),
         trules.opt_state_specs(tp, tf, mesh, zero1=False))
    for B in (256, 1):
        shapes = {"tokens": (B, 4096), "targets": (B, 4096), "step": ()}
        jb = {k: jax.ShapeDtypeStruct(s, "int32") for k, s in shapes.items()}
        tb = {k: torch.empty(s, dtype=torch.int32, device="meta") for k, s in shapes.items()}
        both(f"batch{B}", jrules.batch_specs(jb, mesh), trules.batch_specs(tb, mesh))
        jc = cache_specs(cfg, B, 4096, enc_len=1024)
        tc = dict(tm.cache_specs(tcfg, B, 4096, enc_len=1024),
                  pos=torch.empty((), dtype=torch.int32, device="meta"))
        both(f"cache{B}", jrules.cache_pspecs(jc, mesh), trules.cache_pspecs(tc, mesh))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(jx, arch, mesh):
    sets = _spec_sets(arch, MESHES[mesh], jx)
    for case, (ref, port) in sets.items():
        assert port == ref, (case, {k: (ref.get(k), port.get(k))
                                    for k in set(ref) | set(port) if ref.get(k) != port.get(k)})
    # the rules really shard: tensor parallelism on the attention / mlp
    # weights, FSDP on some dim of the stacked blocks
    fsdp = sets["fsdp"][1]
    assert any("model" in s for s in fsdp.values())
    assert any(any(ax in ("data", ("pod", "data")) for ax in s) for s in fsdp.values())


def test_no_tp_equals_the_reference(jx):
    """``NO_TP`` drops the model axis from every rule and puts batches over
    every axis, in both packages alike."""
    jrules = jx[5]
    old = (jrules.NO_TP, trules.NO_TP)
    jrules.NO_TP = trules.NO_TP = True
    try:
        sets = _spec_sets("qwen1.5-4b", MESHES["2x16x16"], jx)
    finally:
        jrules.NO_TP, trules.NO_TP = old
    for case, (ref, port) in sets.items():
        assert port == ref, case
    assert not any("model" in s for s in sets["plain"][1].values())
    # batches go over all 512 devices: 256 rows cannot, and the axis drops
    assert sets["batch256"][1]["tokens"] == (None, None)


def test_maybe_axis_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert trules.maybe_axis(50280, "model", mesh) is None         # 50280 % 16
    assert trules.maybe_axis(8, "model", mesh) is None             # smaller than the axis
    assert trules.maybe_axis(64, ("pod", "data"), mesh) == ("pod", "data")
    assert trules.maybe_axis(48, ("pod", "data"), mesh) is None    # 48 % 32
    assert trules.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert trules.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        trules.placements(("model", "model"), mesh)


def test_hooks_without_specs_return_their_input():
    g = {"w": torch.ones(2, 3)}
    assert tctx.constrain_grads(g) is g
    assert tctx.constrain_named("ssd_x", g["w"]) is g["w"]
    assert tctx.constrain_moe("tokens", g["w"]) is g["w"]
    assert tctx.get_moe_specs() is None
    tctx.set_moe_specs({"impl": "scatter", "mesh": MESHES["16x16"],
                        "tokens": ("data", None)})
    try:
        assert tctx.moe_spec("tokens", (64, 8)) == ("data", None)
        assert tctx.moe_spec("tokens", (8, 8)) == (None, None)      # 8 < 16
        assert tctx.moe_spec("buf", (64, 8)) is None
        x = torch.ones(64, 8)
        assert tctx.constrain_moe("tokens", x) is x                 # not a DTensor
    finally:
        tctx.set_moe_specs(None)
    with pytest.raises(ValueError):
        tctx.set_grad_specs({"w": (None, None)})                    # no mesh


def _run_script(tmp_path, body: str, timeout=300) -> dict:
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import torch
        torch.set_num_threads(1)
        OUT = {str(tmp_path)!r}
    """) + textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh_on_the_fake_backend(tmp_path, multi_pod, world):
    out = _run_script(tmp_path, f"""
        from types import SimpleNamespace
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch import models as tm
        from repro_torch.configs import get_config
        from repro_torch.launch import make_host_mesh, make_production_mesh
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.sharding import rules
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size={world})
        m = make_production_mesh(multi_pod={multi_pod})
        flat = SimpleNamespace(shape=dict(zip(m.mesh_dim_names, m.shape)),
                               axis_names=m.mesh_dim_names)
        params = tm.init_params(0, get_config("dbrx-132b"), device="meta")
        same = (rules.param_specs(params, m, extra_leading=1, fsdp_axes=rules.data_axes(m))
                == rules.param_specs(params, flat, extra_leading=1,
                                     fsdp_axes=rules.data_axes(flat)))
        h = make_host_mesh(model=16)
        print(json.dumps({{"shape": list(m.shape), "names": list(m.mesh_dim_names),
                          "size": m.size(), "device": m.device_type, "same": same,
                          "host": list(h.shape), "peak": mesh_mod.PEAK_FLOPS_BF16}}))
        dist.destroy_process_group()
    """)
    want = [2, 16, 16] if multi_pod else [16, 16]
    assert out["shape"] == want and out["size"] == world and out["device"] == "cpu"
    assert out["names"] == (["pod", "data", "model"] if multi_pod else ["data", "model"])
    assert out["same"] and out["host"] == [world // 16, 16]
    assert out["peak"] == 989.4e12


def test_hooks_on_a_4_rank_gloo_group(tmp_path):
    """On a (2, 2) ("data", "model") mesh: replicated DTensor grads take
    their params' placements (and keep their values); a sharded one gathers
    back to replicated; ``constrain_moe`` drops an axis the dim does not
    divide; ``constrain_named`` applies its spec; plain tensors pass."""
    out = _run_script(tmp_path, """
        import torch.distributed as dist
        import torch.multiprocessing as mp

        def rank_main(rank, store):
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import Replicate, Shard, distribute_tensor
            from repro_torch.sharding import context as ctx
            dist.init_process_group("gloo", init_method=store, rank=rank, world_size=4)
            pl = lambda t: [f"S{p.dim}" if p.is_shard() else "R" for p in t.placements]
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            g = torch.Generator().manual_seed(0)
            w, b = torch.randn(4, 6, generator=g), torch.randn(8, generator=g)
            rep = [Replicate(), Replicate()]
            grads = {"w": distribute_tensor(w, mesh, rep), "b": distribute_tensor(b, mesh, rep),
                     "plain": torch.ones(3)}
            ctx.set_grad_specs({"w": (None, "model"), "b": ("data",), "plain": (None,)}, mesh)
            out = ctx.constrain_grads(grads)
            res = {"w": pl(out["w"]), "b": pl(out["b"]),
                   "values": bool(torch.equal(out["w"].full_tensor(), w)
                                  and torch.equal(out["b"].full_tensor(), b)),
                   "plain": out["plain"] is grads["plain"],
                   "local_w": list(out["w"].to_local().shape)}
            ctx.set_grad_specs({"w": (None, None), "b": (None,), "plain": (None,)}, mesh)
            back = ctx.constrain_grads(out)
            res["gathered"] = [pl(back["w"]), bool(torch.equal(back["w"].to_local(), w))]
            ctx.set_grad_specs(None)
            ctx.set_moe_specs({"impl": "scatter", "mesh": mesh, "data_axes": ("data",),
                               "tokens": ("data", None)})
            even = ctx.constrain_moe("tokens", distribute_tensor(torch.ones(6, 4), mesh, rep))
            odd = ctx.constrain_moe("tokens", distribute_tensor(torch.ones(3, 4), mesh, rep))
            ctx.set_moe_specs(None)
            ctx.set_named_specs({"ssd_x": (None, None, "model", None)}, mesh)
            x = ctx.constrain_named("ssd_x", distribute_tensor(torch.ones(1, 4, 2, 3), mesh, rep))
            ctx.set_named_specs(None)
            res["moe"] = [pl(even), pl(odd)]
            res["named"] = pl(x)
            with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
                json.dump(res, f)
            dist.destroy_process_group()

        if __name__ == "__main__":
            store = "file://" + os.path.join(OUT, "store")
            mp.spawn(rank_main, args=(store,), nprocs=4, join=True)
            print(json.dumps([json.load(open(os.path.join(OUT, f"rank{r}.json")))
                              for r in range(4)]))
    """)
    for res in out:
        assert res["w"] == ["R", "S1"] and res["b"] == ["S0", "R"]
        assert res["values"] and res["plain"] and res["local_w"] == [4, 3]
        assert res["gathered"] == [["R", "R"], True]
        assert res["moe"] == [["S0", "R"], ["R", "R"]]
        assert res["named"] == ["R", "S2"]
