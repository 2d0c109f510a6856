"""The port's optimizer, data, train steps, checkpoints and trainer CLI
against the JAX package, on the reduced h2o-danube-1.8b (2 layers, f32).

Tolerances:
- AdamW / SGD: updates and moments within rtol 1e-6 (the bias corrections'
  ``b ** step`` and the schedule's ``cos`` are XLA's and torch's f32
  functions, which may differ by an ulp); the schedule within one ulp of
  its ``cos`` term.
- clip_by_global_norm: norm within rtol 1e-6 (per-leaf sums of squares
  reduce in another order).
- ``Optimizer.step`` (clip + update + apply, in place) equals the three
  tree functions bit for bit; data tokens and checkpoints are bitwise.
- 20-step loss trajectories from the same parameters (carried across with
  ``interop.params_from_jax``) and the same batches: step 0 within rtol
  1e-5 (one forward, summation order); every step within rtol 1e-3.  The
  drift is about 1e-4 by step 20 where a top-k threshold or a stochastic
  rounding can flip on an ulp (the compressed runs); past 1e-3 would be a
  fault.  The JAX steps run jitted, as the reference does (XLA then fuses
  multiply-adds the port keeps as two operations); the efbv + qsgd_kernel
  and hier + qsgd runs get the JAX step's own draws injected each step.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SyncConfig as TSync
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import distributed as tdist
from repro_torch.data.synthetic import SyntheticLMDataset as TData
from repro_torch.data.synthetic import lm_batch_iterator as titer
from repro_torch.interop import params_from_jax
from repro_torch.kernels.ops import tile_rows
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import steps as tsteps
from repro_torch.utils.tree import tree_flatten, tree_map

torch.set_num_threads(2)

ARCH = "h2o-danube-1.8b"
STEPS, SEQ, BATCH = 20, 16, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro.training import steps as jsteps
    return dict(jax=jax, jnp=jnp, jbase=jbase, jget=jget, jinit=jinit, jopt=jopt,
                jsched=jsched, jsteps=jsteps)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
    assert err <= rtol, (what, err)


# ---------------------------------------------------------------------------
# optimizer, schedule, clip, data
# ---------------------------------------------------------------------------
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            "s": rng.standard_normal((3, 5, 7)).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [("adamw", {"weight_decay": 0.1}), ("sgd", {}),
                                     ("sgd", {"momentum": 0.9}),
                                     ("sgd", {"momentum": 0.9, "nesterov": True})])
def test_optimizer_updates_and_state_match_jax(jx, name, kw):
    jnp, jopt, jsched = jx["jnp"], jx["jopt"], jx["jsched"]
    jo = jopt.make_optimizer(name, jsched.cosine_schedule(1e-2, 2, 6), **kw)
    to = topt.make_optimizer(name, tsched.cosine_schedule(1e-2, 2, 6), **kw)
    params = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    # the trainer's route: ``Optimizer.step`` (clip + update + apply in
    # place) against JAX's clip_by_global_norm, update and apply_updates
    jp2, tp2 = dict(jp), {k: v.clone() for k, v in tp.items()}
    js2, ts2 = jo.init(jp2), to.init(tp2)
    for step in range(4):
        g = _opt_tree(10 + step)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in params:
            _close(ju[k], tu[k].numpy(), 1e-6, f"update {k} step {step}")
            if kw.get("momentum") or name == "adamw":
                _close(js.mu[k], ts.mu[k].numpy(), 1e-6, f"mu {k}")
            if name == "adamw":
                _close(js.nu[k], ts.nu[k].numpy(), 1e-6, f"nu {k}")
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        assert ts.step == int(js.step) == step + 1
        gc, _ = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        ju2, js2 = jo.update(gc, js2, jp2)
        jp2 = jopt.apply_updates(jp2, ju2)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        ts2 = to.step(tg, ts2, tp2, scale=topt.clip_scale(topt.tree_norm(tg), 1.0))
        for k in params:
            _close(jp2[k], tp2[k].numpy(), 1e-6, f"step() params {k} step {step}")
            if kw.get("momentum") or name == "adamw":
                _close(js2.mu[k], ts2.mu[k].numpy(), 1e-6, f"step() mu {k}")
            if name == "adamw":
                _close(js2.nu[k], ts2.nu[k].numpy(), 1e-6, f"step() nu {k}")
        assert ts2.step == int(js2.step) == step + 1


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_step_is_clip_update_apply_bit_for_bit(name):
    def run(fused):
        o = topt.make_optimizer(name, tsched.cosine_schedule(1e-2, 2, 6))
        p = {k: torch.from_numpy(v.copy()) for k, v in _opt_tree(1).items()}
        p["h"] = torch.from_numpy(_opt_tree(2)["w"]).to(torch.bfloat16)
        st = o.init(p)
        for step in range(3):
            g = {k: torch.from_numpy(v) * 3.0 for k, v in _opt_tree(20 + step).items()}
            g["h"] = torch.from_numpy(_opt_tree(30 + step)["w"]).to(torch.bfloat16)
            if fused:
                st = o.step(g, st, p, scale=topt.clip_scale(topt.tree_norm(g), 1.0))
            else:
                gc, _ = topt.clip_by_global_norm(g, 1.0)
                u, st = o.update(gc, st, p)
                p = topt.apply_updates(p, u)
        return p, st
    (pa, sa), (pb, sb) = run(True), run(False)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]), k
    assert sa.step == sb.step == 3


def test_schedule_and_clip_match_jax(jx):
    jnp, jopt, jsched = jx["jnp"], jx["jopt"], jx["jsched"]
    js, ts = jsched.cosine_schedule(3e-3, 10, 100), tsched.cosine_schedule(3e-3, 10, 100)
    for step in range(0, 120, 7):
        want, got = float(js(jnp.asarray(step, jnp.int32))), ts(step)
        # one ulp of cos near -1 is 2^-24, scaled by lr * (1 - final) / 2
        assert abs(want - got) <= 3e-3 * 2.0**-24, (step, want, got)
    g = {k: v * 5 for k, v in _opt_tree(3).items()}
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tc_, tn = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    _close(jn, tn.numpy(), 1e-6, "norm")
    for k in g:
        assert tc_[k].dtype == torch.float32
        _close(jc[k], tc_[k].numpy(), 1e-6, k)


def test_synthetic_data_tokens_equal_jax():
    from repro.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    jd, td = SyntheticLMDataset(512, 5000, seed=3), TData(512, 5000, seed=3)
    assert td.tokens.tobytes() == jd.tokens.tobytes()
    ji, ti = lm_batch_iterator(jd, 4, 16, seed=1), titer(td, 4, 16, seed=1)
    for _ in range(3):
        assert next(ti)["tokens"].tobytes() == next(ji)["tokens"].tobytes()


# ---------------------------------------------------------------------------
# 20-step trajectories
# ---------------------------------------------------------------------------
TRAJ = {
    "dense": dict(mode="dense"),
    "dense_accum2": dict(mode="dense", grad_accum=2),
    "efbv_top_k": dict(mode="efbv", compressor="top_k", compress_ratio=0.1),
    "efbv_qsgd_kernel": dict(mode="efbv", compressor="qsgd_kernel"),
    "hier_qsgd": dict(mode="hier", compressor="qsgd", sync_period=2),
    "local": dict(mode="local", sync_period=3),
}


def _tcs(jx, case):
    kw = dict(TRAJ[case])
    accum = kw.pop("grad_accum", 1)
    jcfg = jx["jget"](ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    common = dict(seq_len=SEQ, global_batch=BATCH, lr=3e-3, warmup_steps=5,
                  total_steps=STEPS, grad_accum=accum, remat="dots")
    return (jcfg, jx["jbase"].TrainConfig(model=jcfg, sync=jx["jbase"].SyncConfig(**kw), **common),
            cfg, TTrain(model=cfg, sync=TSync(**kw), **common))


_DRAW_FNS = {}


def _draws(jx, case, key, params):
    """The draws the JAX step makes from its state key this step (one
    jitted function per case: integer hashing and a bit cast, the same bits
    as the step's own)."""
    jax, jnp = jx["jax"], jx["jnp"]
    if case not in ("efbv_qsgd_kernel", "hier_qsgd"):
        return None
    shapes = tuple(p.shape for p in jax.tree_util.tree_leaves(params))
    fn = _DRAW_FNS.get((case, shapes))
    if fn is None:
        def draw(key):
            sub = jax.random.split(key)[1]
            if case == "efbv_qsgd_kernel":
                d = sum(int(np.prod(s)) for s in shapes)
                return [jax.random.uniform(k, (tile_rows(d), 512), jnp.float32)
                        for k in jax.random.split(sub, 2)]
            out = []
            for li, shape in enumerate(shapes):
                shape = shape[1:]
                y = shape[:-1] + (shape[-1] // 256, 256) if shape[-1] % 256 == 0 else shape
                out.append([jax.random.uniform(k, y)
                            for k in jax.random.split(jax.random.fold_in(sub, li), 2)])
            return out
        fn = _DRAW_FNS[(case, shapes)] = jax.jit(draw)
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), fn(key))


@pytest.mark.parametrize("case", list(TRAJ))
def test_twenty_step_loss_trajectory_matches_jax(jx, case):
    jax, jnp, jsteps = jx["jax"], jx["jnp"], jx["jsteps"]
    jcfg, jtc, cfg, ttc = _tcs(jx, case)
    key = jax.random.PRNGKey(0)
    key, kinit = jax.random.split(key)
    jparams = jx["jinit"](kinit, jcfg)
    tparams = params_from_jax(_np(jparams), device="cpu")
    G = 2
    jstate = jsteps.init_train_state(key, jparams, jtc, G, G)
    tstate = tsteps.init_train_state(torch.Generator().manual_seed(0), tparams, ttc, G, G)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jtc, G, G))
    tstep = tsteps.make_train_step(cfg, ttc, G, G)
    it = titer(TData(cfg.vocab_size, 20000, seed=0), BATCH, SEQ, seed=1)
    jl, tl = [], []
    for step in range(STEPS):
        tokens = next(it)["tokens"]
        jb = {"tokens": jnp.asarray(tokens[:, :-1]), "targets": jnp.asarray(tokens[:, 1:])}
        tb = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
              "targets": torch.from_numpy(tokens[:, 1:]).long()}
        noise = _draws(jx, case, jstate.key, jstate.params)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, noise=noise)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert np.isfinite(tl[-1]) and np.isfinite(float(tm["grad_norm"]))
    rel = np.abs(np.array(tl) - np.array(jl)) / np.abs(np.array(jl))
    assert rel[0] <= 1e-5, (case, rel[0])
    assert rel.max() <= 1e-3, (case, rel.max(), rel)
    print(f"{case}: max rel loss gap over {STEPS} steps {rel.max():.3g}")
    assert jl[-1] < jl[0] and tl[-1] < tl[0]            # both learn


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------
def test_jax_checkpoint_loads_bit_for_bit_and_port_round_trips(jx, tmp_path):
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.training.checkpoint import load_checkpoint as jload
    from repro.training.checkpoint import save_checkpoint as jsave
    params = jx["jinit"](jax.random.PRNGKey(1), jx["jget"](ARCH).reduced())
    mixed = {"p": params, "bf": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params["blocks"])}
    jsave(str(tmp_path / "jax.npz"), mixed, step=7)
    like = params_from_jax(_np(mixed), device="cpu")
    zeros = tree_map(torch.zeros_like, like)
    got, step = tckpt.load_checkpoint(str(tmp_path / "jax.npz"), zeros)
    assert step == 7
    for a, b in zip(tree_flatten(got)[0], tree_flatten(like)[0]):
        assert a.dtype == b.dtype and a.view(torch.uint8).equal(b.view(torch.uint8))
    tckpt.save_checkpoint(str(tmp_path / "port.npz"), like, step=9)
    back, step = tckpt.load_checkpoint(str(tmp_path / "port.npz"), zeros)
    assert step == 9
    for a, b in zip(tree_flatten(back)[0], tree_flatten(like)[0]):
        assert a.dtype == b.dtype and a.view(torch.uint8).equal(b.view(torch.uint8))
    meta = json.load(open(tmp_path / "port.json"))
    assert set(meta["dtypes"].values()) == {"bfloat16"} and len(meta["dtypes"]) == \
        len(tree_flatten(mixed["bf"])[0])
    # a JAX reader loads the port's f32 leaves as they are
    jback, _ = jload(str(tmp_path / "port.npz"), {"p": params, "bf": mixed["bf"]})
    for a, b in zip(jax.tree_util.tree_leaves(jback["p"]), jax.tree_util.tree_leaves(params)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_sync_state_round_trips_through_a_checkpoint(tmp_path):
    params = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    st = tdist.sync_state_init(params, 2, TSync(mode="efbv", compressor="qsgd_kernel", bucket_size=8))
    st.h.normal_()
    h, h_bar = tdist.sync_state_trees(st)
    tckpt.save_checkpoint(str(tmp_path / "s"), {"h": h, "h_bar": h_bar})
    back, _ = tckpt.load_checkpoint(str(tmp_path / "s"), {"h": h, "h_bar": h_bar})
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(back)[0], tree_flatten({"h": h, "h_bar": h_bar})[0]))


def test_trainer_cli_runs_on_the_cpu_and_defaults_to_the_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                        "--reduced", "--device", "cpu", "--steps", "3", "--sync", "efbv",
                        "--ckpt", str(tmp_path / "ck")],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "sync=efbv" in r.stdout and "step    2 loss" in r.stdout
    assert (tmp_path / "ck.npz").exists()
    # --dry-run hands the process over to the dry-run with its shape and mesh
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                        "--dry-run", "--shape", "decode_32k", "--multi-pod"],
                       capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "results" / "dryrun"
                      / f"{ARCH}__decode_32k__mp__dense.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["collectives"]
    from repro_torch.launch.train import main
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", ARCH, "--reduced", "--steps", "1"])


@pytest.mark.parametrize("mode", ["hier", "local"])
def test_train_loop_with_faults_degrades_the_sync(mode):
    """The loop's fault path: each round's plan masks the replica sync (the
    depth-1 tree of a flat hier/local run); losses stay finite."""
    from repro_torch.faults import FaultConfig
    from repro_torch.training.loop import train
    cfg = get_config(ARCH).reduced()
    tc = TTrain(model=cfg, seq_len=SEQ, global_batch=BATCH, lr=3e-3, warmup_steps=2,
                total_steps=4, sync=TSync(mode=mode, compressor="top_k", sync_period=1,
                                          faults=FaultConfig(seed=1, availability=0.5)))
    it = titer(TData(cfg.vocab_size, 5000, seed=0), BATCH, SEQ, seed=1)
    lines = []
    state, hist = train(cfg, tc, it, n_groups=2, n_pods=2, steps=4, device="cpu", log=lines.append)
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert any("fault injection on" in m for m in lines)
    assert state.sync_state.step == 4
