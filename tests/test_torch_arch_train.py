"""Training the Mamba2, encoder-decoder, MoE and hybrid architectures: the
port's train step against the JAX package's jitted step, from the same
parameters (``interop.params_from_jax``) and batches, on the reduced
configs (f32).

- ``mamba2-2.7b`` and ``seamless-m4t-large-v2`` (its batches carry
  ``src_embeds``, 0.02 N(0, 1) frames from numpy), each dense and efbv +
  ``qsgd_kernel`` over 2 groups with the JAX step's own draws injected each
  step (as ``tests/test_torch_train.py`` does for danube).
- ``llama4-scout-17b-a16e``, ``dbrx-132b`` and ``jamba-1.5-large-398b``,
  dense.  ``torch.topk`` does not promise JAX's order on ties, so every
  router call of the port is recorded and its top-(K+1) probabilities must
  differ by more than 1e-5 (``tests/test_torch_arch.py``): no routing
  choice can flip between the packages.  The parameter seeds are ones whose
  routers keep that margin through the run.

Tolerances: step 0's loss and grad norm within rtol 1e-5 (one forward and
backward; the SSD chunk loop adds in another order than JAX's associative
scan), every step's within rtol 1e-3, as for danube.  The grad norms hold
each block's backward to JAX's directly: under AdamW's first steps a
gradient of the wrong scale but the right sign barely moves the losses.  8 steps a run (danube's file runs 20).  About 60 s
alone on 2 threads, most of it compiling the JAX steps.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SyncConfig as TSync
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data.synthetic import SyntheticLMDataset as TData
from repro_torch.data.synthetic import lm_batch_iterator as titer
from repro_torch.interop import params_from_jax
from repro_torch.kernels.ops import tile_rows
from repro_torch.models import moe as tmoe
from repro_torch.training import steps as tsteps

torch.set_num_threads(2)
STEPS, SEQ, BATCH, G, SRC = 8, 16, 4, 2, 12
MARGIN = 1e-5
SYNCS = {"dense": dict(mode="dense"),
         "efbv_qsgd_kernel": dict(mode="efbv", compressor="qsgd_kernel")}
# (config, sync, parameter seed)
CASES = [("mamba2-2.7b", "dense", 0), ("mamba2-2.7b", "efbv_qsgd_kernel", 0),
         ("seamless-m4t-large-v2", "dense", 0),
         ("seamless-m4t-large-v2", "efbv_qsgd_kernel", 0),
         ("llama4-scout-17b-a16e", "dense", 1), ("dbrx-132b", "dense", 1),
         ("jamba-1.5-large-398b", "dense", 1)]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro.training import steps as jsteps
    return dict(jax=jax, jnp=jnp, jbase=jbase, jget=jget, jinit=jinit, jsteps=jsteps)


def _np(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _efbv_draws(jx, key, d):
    """The two groups' (tile_rows(d), 512) uniform draws the JAX efbv step
    makes from its state key this step."""
    jax, jnp = jx["jax"], jx["jnp"]
    sub = jax.random.split(key)[1]
    return [torch.from_numpy(np.array(jax.random.uniform(k, (tile_rows(d), 512), jnp.float32)))
            for k in jax.random.split(sub, G)]


@pytest.fixture
def margins(monkeypatch):
    calls = []
    route = tmoe.route

    def recording(router, xt, num_experts, top_k, *a, **kw):
        r = route(router, xt, num_experts, top_k, *a, **kw)
        calls.append((r.probs.detach(), top_k))
        return r

    monkeypatch.setattr(tmoe, "route", recording)

    def check():
        for probs, K in calls:
            p = probs.double().sort(dim=-1, descending=True).values[:, :K + 1]
            assert float((p[:, :-1] - p[:, 1:]).min()) > MARGIN
        return len(calls)

    return check


@pytest.mark.parametrize("arch,sync,seed", CASES, ids=[f"{a}-{s}" for a, s, _ in CASES])
def test_loss_trajectory_matches_jax(jx, arch, sync, seed, margins):
    jax, jnp, jsteps, jbase = jx["jax"], jx["jnp"], jx["jsteps"], jx["jbase"]
    jcfg, cfg = jx["jget"](arch).reduced(), get_config(arch).reduced()
    common = dict(seq_len=SEQ, global_batch=BATCH, lr=3e-3, warmup_steps=5,
                  total_steps=STEPS, remat="dots")
    jtc = jbase.TrainConfig(model=jcfg, sync=jbase.SyncConfig(**SYNCS[sync]), **common)
    ttc = TTrain(model=cfg, sync=TSync(**SYNCS[sync]), **common)
    key, kinit = jax.random.split(jax.random.PRNGKey(seed))
    jparams = jx["jinit"](kinit, jcfg)
    tparams = params_from_jax(_np(jax, jparams), device="cpu")
    d = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jparams))
    jstate = jsteps.init_train_state(key, jparams, jtc, G, G)
    tstate = tsteps.init_train_state(torch.Generator().manual_seed(0), tparams, ttc, G, G)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jtc, G, G))
    tstep = tsteps.make_train_step(cfg, ttc, G, G)
    it = titer(TData(cfg.vocab_size, 20000, seed=0), BATCH, SEQ, seed=1)
    rng = np.random.default_rng(seed + 7)
    jl, tl, jg, tg = [], [], [], []
    for step in range(STEPS):
        tokens = next(it)["tokens"]
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        if cfg.enc_layers:
            batch["src_embeds"] = (0.02 * rng.normal(size=(BATCH, SRC, cfg.enc_d_model))
                                   ).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
        noise = _efbv_draws(jx, jstate.key, d) if sync != "dense" else None
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, noise=noise)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        jg.append(float(jm["grad_norm"]))
        tg.append(float(tm["grad_norm"]))
        assert np.isfinite(tl[-1]) and np.isfinite(tg[-1])
    rel = np.abs(np.array(tl) - np.array(jl)) / np.abs(np.array(jl))
    grel = np.abs(np.array(tg) - np.array(jg)) / np.abs(np.array(jg))
    assert rel[0] <= 1e-5, (arch, sync, rel[0])
    assert rel.max() <= 1e-3, (arch, sync, rel.max(), rel)
    assert grel[0] <= 1e-5, (arch, sync, grel[0])
    assert grel.max() <= 1e-3, (arch, sync, grel.max(), grel)
    if cfg.moe:
        assert margins() > 0
    print(f"{arch} {sync}: max rel loss gap over {STEPS} steps {rel.max():.3g}, "
          f"grad norm gap {grel.max():.3g} (step 0 {grel[0]:.3g})")


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 1e-5)])
def test_grad_norm_in_slices_matches_jax(jx, dtype, rtol, monkeypatch):
    """``tree_norm`` sums a leaf wider than ``SLICE_ELEMS`` slice by slice
    along its first axis (at full width no whole f32 temporaries of a
    stacked leaf): within rtol 1e-6 of the whole-leaf sum, and both within
    ``rtol`` of JAX's norm (the f32 squares of 6e4 bf16 values, summed in
    another order, drift by ~3e-6)."""
    from repro.utils.tree import tree_norm as jnorm
    from repro_torch.optim import optimizers as topt
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((64, 40, 24)), "b": rng.standard_normal(7)}
    jt = {k: jnp.asarray(v, dtype=dtype) for k, v in tree.items()}
    tt = params_from_jax(_np(jax, jt), device="cpu")
    want = float(jnorm(jt))
    whole = float(topt.tree_norm(tt))
    monkeypatch.setattr(topt, "SLICE_ELEMS", 1000)
    assert len(list(topt._slices(tt["w"]))) == 64
    sliced = float(topt.tree_norm(tt))
    assert abs(sliced - whole) <= 1e-6 * whole
    assert abs(whole - want) <= rtol * want and abs(sliced - want) <= rtol * want
