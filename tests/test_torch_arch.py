"""The MoE, Mamba2, hybrid and encoder-decoder architectures in the port
against the JAX package, from the same parameters (``params_from_jax``):
the tree layout, the full-sequence forward and loss, prefill + decode,
decode against teacher forcing, the cache layout, and serving (the
personalized batcher, the delta engine, the continuous batcher, the
launcher and ``examples.serve_decode``).

Tolerances (f32 logits):
- attention-only configs (llama4, dbrx, seamless): atol 2e-5, the dense
  model's bound (``tests/test_torch_model.py``): one masked softmax where
  JAX tiles it, matmuls summed in another order;
- configs with SSD layers (mamba2, jamba): the port's chunk loop adds in
  another order than JAX's associative scan, so logits are held to 1e-4
  relative to their max, the JAX package's own decode-vs-forward bound
  (``tests/test_arch_smoke.py``);
- greedy tokens equal everywhere.
MoE routing: ``torch.topk`` does not promise JAX's lower-index-first order
on ties, so each MoE model test records every router call of the port and
asserts that adjacent sorted probabilities through rank K + 1 differ by
more than 1e-5, far above f32 rounding: on these inputs no top-k choice or
order can flip between the packages.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import numpy_from_tensor, params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

torch.set_num_threads(2)
ATOL = 2e-5
SSD_REL = 1e-4
MARGIN = 1e-5
NEW = ("dbrx-132b", "jamba-1.5-large-398b", "llama4-scout-17b-a16e", "mamba2-2.7b",
       "seamless-m4t-large-v2")
SSD = ("jamba-1.5-large-398b", "jamba-period", "mamba2-2.7b")
JAMBA_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.configs import get_config
    return jax, jnp, jm, get_config


def _cfgs(jx, arch):
    """(JAX config, port config), reduced, f32; "jamba-period" is jamba's
    own 8-layer period (attention + Mamba + MoE interleave) at the reduced
    widths."""
    get_config = jx[3]
    if arch == "jamba-period":
        jc = replace(get_config("jamba-1.5-large-398b").reduced(), num_layers=8,
                     layer_pattern=JAMBA_PERIOD)
        tc = replace(t_get_config("jamba-1.5-large-398b").reduced(), num_layers=8,
                     layer_pattern=JAMBA_PERIOD)
        return jc, tc
    return get_config(arch).reduced(), t_get_config(arch).reduced()


def _np(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(jx, cfg, seed=0):
    jax = jx[0]
    jp = jx[2].init_params(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_jax(_np(jax, jp), device="cpu")


def _side(cfg, B, seed):
    """Frame and patch embeddings for the configs that take them (numpy)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))
                                ).astype(np.float32)
    if cfg.enc_layers:
        out["src_embeds"] = (0.02 * rng.normal(size=(B, 12, cfg.enc_d_model or cfg.d_model))
                             ).astype(np.float32)
    return out


def _batches(jnp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb = {k: v.long() if k in ("tokens", "targets") else v for k, v in tb.items()}
    return jb, tb


def _close(arch, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if arch in SSD:
        err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)
        assert err < SSD_REL, err
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture
def margins(monkeypatch):
    """Records every router call of the port; ``check()`` asserts the
    top-(K+1) margins of all of them (module docstring)."""
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


# ---------------------------------------------------------------------------
# configs and tree layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", NEW)
def test_init_layout_matches_jax(jx, arch, size):
    """Paths, shapes and dtypes of ``init_params`` equal JAX's: reduced on
    the CPU, full size on the ``meta`` device (JAX's by ``eval_shape``)."""
    jax, jnp, jm, get_config = jx
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if size == "reduced":
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    theirs = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), cfg))
    theirs = jax.tree_util.tree_flatten_with_path(theirs)[0]
    ours, _ = tree_flatten_with_path(
        tm.init_params(0, tcfg, device="cpu" if size == "reduced" else "meta"))
    assert [k for k, _ in ours] == [jax.tree_util.keystr(p) for p, _ in theirs]
    assert [tuple(v.shape) for _, v in ours] == [tuple(v.shape) for _, v in theirs]
    assert [str(v.dtype).split(".")[-1] for _, v in ours] == [str(v.dtype) for _, v in theirs]
    if size == "full":
        assert sum(v.numel() for _, v in ours) >= tcfg.param_count() * 0.99


@pytest.mark.parametrize("arch", NEW)
def test_params_from_jax_crosses_mixed_bf16_and_f32_trees(jx, arch):
    """A bf16 MoE or Mamba model keeps f32 leaves (``router``, ``a_log``,
    ``dt_bias``, ``D``): every leaf crosses bit for bit in its own dtype."""
    jax, jnp, jm, get_config = jx
    cfg = replace(get_config(arch).reduced(), dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    theirs = jax.tree_util.tree_flatten_with_path(jp)[0]
    crossed, _ = tree_flatten_with_path(params_from_jax(_np(jax, jp), device="cpu"))
    dtypes = set()
    for (name, t), (_, j) in zip(crossed, theirs):
        j = np.asarray(j)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        want = j.view(np.uint16) if j.dtype.name == "bfloat16" else j
        assert numpy_from_tensor(t).tobytes() == want.tobytes(), name
        dtypes.add(str(j.dtype))
    # seamless has no router or SSD leaves: bf16 alone
    assert dtypes == ({"bfloat16", "float32"} if cfg.moe or cfg.mamba else {"bfloat16"})


@pytest.mark.parametrize("arch", NEW)
def test_cache_specs_match_jax(jx, arch):
    jax, jnp, jm, _ = jx
    cfg, tcfg = _cfgs(jx, arch)
    theirs = jm.cache_specs(cfg, 2, 40, enc_len=12)
    ours = tm.cache_specs(tcfg, 2, 40, enc_len=12)
    assert sorted(ours["layers"]) == sorted(theirs["layers"])
    for name, leaves in theirs["layers"].items():
        assert sorted(ours["layers"][name]) == sorted(leaves)
        for k, s in leaves.items():
            t = ours["layers"][name][k]
            assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[-1] == str(s.dtype)
    assert ("enc_memory" in ours) == ("enc_memory" in theirs)
    if "enc_memory" in ours:
        assert tuple(ours["enc_memory"].shape) == theirs["enc_memory"].shape


def test_llama4_chunked_cache_is_bounded_at_full_size():
    """The chunked layers of full-size llama4 hold an attn_chunk-sized cache
    at 524,288 tokens, the global (NoPE) layer the whole context."""
    cfg = t_get_config("llama4-scout-17b-a16e")
    specs = tm.cache_specs(cfg, batch=1, seq_len=524288)["layers"]
    for j, kind in enumerate(cfg.layer_kinds()[:len(specs)]):
        S = specs[f"pos{j}"]["k"].shape[2]
        assert S == (cfg.attn_chunk if kind == "attn_chunk" else 524288)


# ---------------------------------------------------------------------------
# forward, prefill and decode against JAX
# ---------------------------------------------------------------------------
ARCH_CASES = NEW + ("jamba-period",)


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_forward_and_loss_match_jax(jx, arch, margins):
    jax, jnp, jm, _ = jx
    cfg, tcfg = _cfgs(jx, arch)
    jp, tp = _params(jx, cfg, seed=1)
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32),
             **_side(cfg, 2, 3)}
    jb, tb = _batches(jnp, batch)
    jl, jaux = jm.forward_train(jp, cfg, jb)
    tl, taux = tm.forward_train(tp, tcfg, tb)
    _close(arch, tl.detach().numpy(), jl)
    jloss, jparts = jm.loss_fn(jp, cfg, jb)
    tloss, tparts = tm.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["aux"]), float(jparts["aux"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if cfg.moe:
        assert float(taux) > 0 and margins() > 0


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_prefill_and_decode_match_jax(jx, arch, margins):
    """Prefill (its logits and every cache leaf) and two decode steps from
    the same cache."""
    jax, jnp, jm, _ = jx
    cfg, tcfg = _cfgs(jx, arch)
    jp, tp = _params(jx, cfg, seed=2)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
    jb, tb = _batches(jnp, {"tokens": toks, **_side(cfg, 2, 5)})
    jl, jc = jm.prefill(jp, cfg, jb, cache_len=32)
    tl, tc = tm.prefill(tp, tcfg, tb, cache_len=32)
    _close(arch, tl.numpy(), jl)
    assert tc["pos"] == int(jc["pos"]) == 20
    for name, leaves in jc["layers"].items():
        for k, v in leaves.items():
            _close(arch, tc["layers"][name][k].numpy(), v)
    if cfg.enc_layers:
        np.testing.assert_allclose(tc["enc_memory"].numpy(), np.asarray(jc["enc_memory"]),
                                   atol=ATOL, rtol=0)
    tok = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))[:, None]
    assert np.array_equal(tok[:, 0], tl[:, -1, :cfg.vocab_size].argmax(-1).numpy())
    for _ in range(2):
        jl, jc = jm.decode_step(jp, cfg, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tc)
        _close(arch, tl.numpy(), jl)
        jt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        assert np.array_equal(jt, tl[:, -1, :cfg.vocab_size].argmax(-1).numpy())
        tok = jt[:, None]
    assert tc["pos"] == int(jc["pos"]) == 22
    if cfg.moe:
        assert margins() > 0


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "mamba2-2.7b"))
def test_serving_step_factories_match_jax(jx, arch):
    """``training.steps.make_prefill_step`` / ``make_decode_step`` against
    the JAX package's factories: one reduced prefill and one decode step."""
    from repro.training import steps as jsteps
    from repro_torch.training import steps as tsteps
    jax, jnp, _, _ = jx
    cfg, tcfg = _cfgs(jx, arch)
    jp, tp = _params(jx, cfg, seed=3)
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = _batches(jnp, {"tokens": toks})
    jl, jc = jsteps.make_prefill_step(cfg)(jp, jb)
    tl, tc = tsteps.make_prefill_step(tcfg)(tp, tb)
    _close(arch, tl.numpy(), jl)
    tok = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))[:, None]
    jl, jc = jsteps.make_decode_step(cfg)(jp, jnp.asarray(tok, jnp.int32), jc)
    tl, tc = tsteps.make_decode_step(tcfg)(tp, torch.tensor(tok).long(), tc)
    _close(arch, tl.numpy(), jl)
    assert tc["pos"] == int(jc["pos"]) == 13


@pytest.mark.parametrize("arch", ("dbrx-132b", "jamba-1.5-large-398b", "jamba-period",
                                  "llama4-scout-17b-a16e", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"))
def test_decode_matches_teacher_forcing(jx, arch):
    """The port's own counterpart of the JAX package's
    ``test_decode_matches_forward``: prefill 20 tokens, decode 2, each
    step's logits within 1e-4 of the full forward's, relative to its max
    (MoE with a capacity that drops nothing, as there)."""
    _, tcfg = _cfgs(jx, arch)
    if tcfg.moe:
        tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=float(
            tcfg.moe.num_experts) / tcfg.moe.top_k))
    tp = tm.init_params(1, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 22)))
    side = {k: torch.from_numpy(v) for k, v in _side(tcfg, 2, 7).items()}
    full, _ = tm.forward_train(tp, tcfg, {"tokens": toks, **side})
    _, cache = tm.prefill(tp, tcfg, {"tokens": toks[:, :20], **side}, cache_len=23)
    for t in (20, 21):
        lg, cache = tm.decode_step(tp, tcfg, toks[:, t:t + 1], cache)
        a, b = full[:, t].detach().numpy(), lg[:, 0].numpy()
        assert np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9) < 1e-4


def test_loss_backward_reaches_every_leaf():
    """The trainer's backward through Mamba, MoE and cross-attention blocks,
    with and without per-period checkpointing: every leaf gets a finite
    gradient, and remat changes no value."""
    for arch in ("jamba-1.5-large-398b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2"):
        cfg = t_get_config(arch).reduced()
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13)))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 **{k: torch.from_numpy(v) for k, v in _side(cfg, 2, 0).items()}}
        grads = []
        for remat in ("none", "dots"):
            params = tm.init_params(0, cfg, device="cpu")
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = tm.loss_fn(params, cfg, batch, remat=remat)
            loss.backward()
            assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in leaves)
            grads.append([p.grad for p in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve_world(jx, arch):
    """Reduced JAX params + 2 norm-personalized users, the same trees in the
    port, and both packages' qsgd_kernel stores of them (JAX's noise
    injected)."""
    jax, jnp, jm, get_config = jx
    from repro.core.compressors import make_compressor as j_make
    from repro.serve import DeltaStore as JStore
    from repro.serve import personalize_leaves as j_personalize
    from repro_torch.core.compressors import make_compressor
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.serve import DeltaStore

    cfg = get_config(arch).reduced()
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    pers = [j_personalize(jp, jax.random.fold_in(jax.random.PRNGKey(1), u)) for u in range(2)]
    to_t = lambda t: params_from_jax(_np(jax, t), device="cpu")
    js = JStore(jp, j_make("qsgd_kernel", bits=8), block_size=4096, seed=7)
    ts = DeltaStore(to_t(jp), make_compressor("qsgd_kernel", bits=8), block_size=4096, seed=7)
    for uid in range(2):
        js.put(uid, pers[uid])
        noise = torch.from_numpy(np.array(jax.random.uniform(
            js.user_key(uid), (tile_rows(js.layout.padded_d), 512), jnp.float32)))
        ts.put(uid, to_t(pers[uid]), noise=noise)
    return cfg, t_get_config(arch).reduced(), js, ts


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "dbrx-132b"])
def test_personalized_batcher_generates_the_jax_tokens(jx, arch, margins):
    """6 requests over 2 slots, two users + the base: the same tokens, pool
    stats and page-in bytes as the JAX batcher."""
    from repro.serve import BlockPool as JPool
    from repro.serve import PersonalizedBatcher as JBatcher
    from repro.training.serving import Request as JRequest
    from repro_torch.comm.ledger import PAGE_IN_TAG
    from repro_torch.serve import BlockPool, PersonalizedBatcher
    from repro_torch.training.serving import Request

    cfg, tcfg, js, ts = _serve_world(jx, arch)
    runs = []
    for Pool, Batcher, Req, store, c in ((JPool, JBatcher, JRequest, js, cfg),
                                         (BlockPool, PersonalizedBatcher, Request, ts, tcfg)):
        pool = Pool(store, 64, metrics=None)
        b = Batcher(c, store, pool, n_slots=2, max_len=64)
        reqs = [Req(rid=i, prompt=np.arange(3 + i, 12 + 2 * i, dtype=np.int32), max_new=4,
                    user_id=(0, 1, None)[i % 3]) for i in range(6)]
        for r in reqs:
            b.submit(r)
        assert b.run(max_ticks=200).completed == 6
        runs.append(([r.generated for r in reqs], pool.stats(),
                     store.ledger.bytes_by_tag()[PAGE_IN_TAG]))
    assert runs[0] == runs[1]
    if tcfg.moe:
        assert margins() > 0


def test_delta_path_bitwise_equals_materialized_mamba2(jx):
    """Each slot serving base + its paged delta equals serving the user's
    materialized params bit for bit, in prefill and every decode step (the
    Mamba state updated in place in both caches)."""
    from repro_torch.comm.buckets import debucketize
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import BlockPool, DeltaServeEngine

    _, tcfg, _, ts = _serve_world(jx, "mamba2-2.7b")
    pool = BlockPool(ts, 64, metrics=MetricsRegistry())
    eng = DeltaServeEngine(tcfg, ts, max_len=32)
    tables = torch.stack([pool.acquire(u).table for u in range(2)] +
                         [torch.zeros_like(pool.table_for(0))])
    eff = eng.eff_blocks_for([ts.personalized_params(0), ts.personalized_params(1),
                              debucketize(ts.base_blocks, ts.layout)])
    toks = torch.arange(1, 34).reshape(3, 11)             # 11 tokens: a padded chunk
    logits, cache = eng.prefill(pool, tables, toks)
    lm, cm = eng.prefill_materialized(eff, toks)
    assert torch.equal(logits, lm)
    for _ in range(4):
        tok = logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None]
        logits, cache = eng.decode(pool, tables, tok, cache)
        lm, cm = eng.decode_materialized(eff, tok, cm)
        assert torch.equal(logits, lm)
    assert not torch.equal(logits[0], logits[2])          # the users' deltas act


def test_continuous_batcher_on_seamless_gives_the_jax_tokens(jx):
    """Ragged prompts and refills; the encoder sees the batcher's zero frame
    embeddings in both packages."""
    from repro.training.serving import ContinuousBatcher as JBatcher
    from repro.training.serving import Request as JRequest
    from repro_torch.training.serving import ContinuousBatcher, Request

    cfg, tcfg = _cfgs(jx, "seamless-m4t-large-v2")
    jp, tp = _params(jx, cfg, seed=1)
    runs = []
    for Batcher, Req, params, c in ((JBatcher, JRequest, jp, cfg),
                                    (ContinuousBatcher, Request, tp, tcfg)):
        b = Batcher(c, params, n_slots=2, max_len=48)
        reqs = [Req(rid=i, prompt=np.arange(2 + i, 9 + 2 * i, dtype=np.int32),
                    max_new=3 + i % 2) for i in range(4)]
        for r in reqs:
            b.submit(r)
        stats = b.run(max_ticks=100)
        runs.append(([r.generated for r in reqs], stats.prefills, stats.decode_steps))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("arch", NEW)
def test_delta_engine_serves_decoder_only_configs_as_jax_does(jx, arch):
    """Seamless (encoder) and llama4 (vision) are refused, as by the JAX
    engine; every other config is served."""
    jax, jnp, jm, get_config = jx
    from repro.core.compressors import make_compressor as j_make
    from repro.serve import DeltaServeEngine as JEngine
    from repro.serve import DeltaStore as JStore
    from repro_torch.core.compressors import make_compressor
    from repro_torch.serve import DeltaServeEngine, DeltaStore

    cfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    jstore = JStore(jm.init_params(jax.random.PRNGKey(0), cfg), j_make("top_k", k_frac=0.01),
                    block_size=4096)
    tstore = DeltaStore(tm.init_params(0, tcfg, device="cpu"), make_compressor("top_k", k_frac=0.01),
                        block_size=4096)
    refused = []
    for Engine, c, store in ((JEngine, cfg, jstore), (DeltaServeEngine, tcfg, tstore)):
        try:
            Engine(c, store, max_len=16)
            refused.append(None)
        except NotImplementedError as e:
            refused.append(str(e))
    assert refused[0] == refused[1]
    assert (refused[1] is not None) == (arch in ("seamless-m4t-large-v2",
                                                 "llama4-scout-17b-a16e"))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "seamless-m4t-large-v2"])
def test_generate_with_the_jax_side_inputs_gives_the_jax_tokens(jx, arch, margins):
    """``launch.serve.generate`` takes the frame / patch embeddings as
    arguments: fed the JAX launcher's own draws it decodes the JAX tokens."""
    jax, jnp, jm, _ = jx
    from repro_torch.launch.serve import generate

    cfg, tcfg = _cfgs(jx, arch)
    jp, tp = _params(jx, cfg, seed=0)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompt)}
    if cfg.enc_layers:
        batch["src_embeds"] = 0.02 * jax.random.normal(jax.random.PRNGKey(1),
                                                       (2, 16, cfg.enc_d_model))
    if cfg.vision_tokens:
        batch["vision_embeds"] = 0.02 * jax.random.normal(
            jax.random.PRNGKey(2), (2, cfg.vision_tokens, cfg.d_model))
    logits, cache = jm.prefill(jp, cfg, batch, cache_len=16 + 6 + 1)
    tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None].astype(jnp.int32)
    want = []
    for _ in range(6):
        logits, cache = jm.decode_step(jp, cfg, tok, cache)
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    side = {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if k != "tokens"}
    got = generate(tcfg, tp, torch.from_numpy(prompt).long(), 6, **side)
    assert np.array_equal(got, np.stack(want, 1))
    if cfg.moe:
        assert margins() > 0


@pytest.mark.parametrize("arch", NEW)
def test_launch_serve_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", arch, "--reduced", "--batch", "2", "--gen", "3",
                "--device", "cpu"])
    assert out.shape == (2, 3) and out.max() < t_get_config(arch).reduced().vocab_size
    assert "decoded:" in capsys.readouterr().out


def test_serve_decode_example_on_cpu(capsys):
    from repro_torch.examples.serve_decode import main
    outs = main(["--batch", "3", "--gen", "5", "--device", "cpu"])     # mamba2-2.7b
    assert len(outs) == 3 and all(1 <= len(o) <= 5 for o in outs)
    assert "decoded" in capsys.readouterr().out
