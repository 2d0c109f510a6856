"""Port model (dense decoder, prefill + ring-cache decode) against the JAX
package, from the same parameters (``params_from_jax``).

Tolerance: logits within atol 2e-5 in f32 (the port's attention is one
masked softmax where JAX tiles it flash-style, and matmuls sum in another
order; the observed gap is ~1e-6 on logits of magnitude ~1); greedy tokens
must be equal.  The prompt (24) is longer than the reduced SWA window (16),
so the decode ring wraps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import numpy_from_tensor, params_from_jax
from repro_torch.utils.tree import tree_flatten_with_path

torch.set_num_threads(2)
ATOL = 2e-5
ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import decode_step, init_params, prefill
    return jax, jnp, get_config, init_params, prefill, decode_step


def _np(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


KINDS = {"swa": dict(), "global": dict(sliding_window=0),
         "chunk": dict(sliding_window=0, attn_chunk=8),
         # the layer options other configs of the JAX package use
         "bias_qknorm_tied_gelu": dict(qkv_bias=True, qk_norm=True,
                                       tie_embeddings=True, mlp_act="gelu"),
         "plain_relu2": dict(mlp_gated=False, mlp_act="relu2")}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_and_decode_match_jax(jx, kind):
    jax, jnp, get_config, init_params, prefill, decode_step = jx
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **KINDS[kind])
    tcfg = dataclasses.replace(t_get_config(ARCH).reduced(), **KINDS[kind])
    jp = init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(_np(jax, jp), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, cache_len=40)
    tl, tcache = tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, cache_len=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name, layer in jc["layers"].items():
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache["layers"][name][k].numpy(),
                                       np.asarray(layer[k]), atol=ATOL, rtol=0)
    tok = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))[:, None]
    assert np.array_equal(tok[:, 0], tl[:, -1, :tcfg.vocab_size].argmax(-1).numpy())
    for _ in range(8):
        jl, jc = decode_step(jp, cfg, jnp.asarray(tok, jnp.int32), jc)
        tl, tcache = tm.decode_step(tp, tcfg, torch.tensor(tok).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        jt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        assert np.array_equal(jt, tl[:, -1, :tcfg.vocab_size].argmax(-1).numpy())
        tok = jt[:, None]
    assert tcache["pos"] == int(jc["pos"]) == 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_jax_and_bf16_crosses_bitwise(jx, dtype):
    jax, jnp, get_config, init_params = jx[:4]
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(ARCH).reduced(), dtype=dtype)
    jp = init_params(jax.random.PRNGKey(0), cfg)
    ours, _ = tree_flatten_with_path(tm.init_params(0, tcfg, device="cpu"))
    theirs = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in ours] == [jax.tree_util.keystr(p) for p, _ in theirs]
    assert [tuple(v.shape) for _, v in ours] == [tuple(v.shape) for _, v in theirs]
    assert {str(v.dtype).split(".")[-1] for _, v in ours} == {dtype}
    crossed, _ = tree_flatten_with_path(params_from_jax(_np(jax, jp), device="cpu"))
    for (_, t), (_, j) in zip(crossed, theirs):
        j = np.asarray(j)
        want = j.view(np.uint16) if dtype == "bfloat16" else j
        assert numpy_from_tensor(t).tobytes() == want.tobytes()


def test_launch_serve_greedy_on_cpu(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", ARCH, "--reduced", "--batch", "2", "--gen", "5",
                "--device", "cpu"])
    assert out.shape == (2, 5) and out.max() < t_get_config(ARCH).reduced().vocab_size
    assert "decoded:" in capsys.readouterr().out


def test_continuous_batcher_matches_jax(jx):
    """Ragged prompts, refills into running slots: same tokens as the JAX
    batcher from the same params."""
    jax, jnp, get_config, init_params = jx[:4]
    from repro.training.serving import ContinuousBatcher as JBatcher
    from repro.training.serving import Request as JRequest
    from repro_torch.training.serving import ContinuousBatcher, Request

    cfg = get_config(ARCH).reduced()
    jp = init_params(jax.random.PRNGKey(1), cfg)
    tp = params_from_jax(_np(jax, jp), device="cpu")
    runs = []
    for Batcher, Req, params, c in ((JBatcher, JRequest, jp, cfg),
                                    (ContinuousBatcher, Request, tp, t_get_config(ARCH).reduced())):
        b = Batcher(c, params, n_slots=2, max_len=48)
        reqs = [Req(rid=i, prompt=np.arange(2 + i, 7 + 2 * i, dtype=np.int32),
                    max_new=3 + i % 2) for i in range(4)]
        for r in reqs:
            b.submit(r)
        stats = b.run(max_ticks=100)
        runs.append(([r.generated for r in reqs], stats.prefills, stats.decode_steps))
    assert runs[0] == runs[1]
