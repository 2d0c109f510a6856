"""The port's dense configs (``repro_torch/configs``) against the JAX
package's: every field and ``param_count`` equal, and the full-sequence
forward of each ``reduced()`` config (f32) within atol 2e-5 of
``repro.models.forward_train`` from the same parameters (the port's
attention is one masked softmax where JAX tiles it; matmuls sum in another
order).  The configs the port does not run yet (MoE, Mamba, encoder-decoder,
vision) stay unregistered; ``tests/test_torch_model.py`` holds
``require_supported`` raising for their layer kinds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs as t_list_configs
from repro_torch.interop import params_from_jax
from repro_torch.models.transformer import require_supported

torch.set_num_threads(2)
ATOL = 2e-5
DENSE = ("chameleon-34b", "h2o-danube-1.8b", "nemotron-4-15b", "qwen1.5-110b", "qwen1.5-4b")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import forward_train, init_params
    return jax, jnp, get_config, init_params, forward_train


def test_the_port_registers_the_five_dense_configs():
    assert t_list_configs() == sorted(DENSE)


@pytest.mark.parametrize("arch", DENSE)
def test_fields_and_param_count_match_jax(jx, arch):
    get_config = jx[2]
    cfg, tcfg = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.param_count() == cfg.param_count()
    assert tcfg.active_param_count() == cfg.active_param_count()
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(cfg.reduced())
    require_supported(tcfg)                   # every dense config runs


def test_qwen1_5_4b_at_full_width():
    cfg = t_get_config("qwen1.5-4b")
    assert cfg.qkv_bias and (cfg.num_layers, cfg.d_model, cfg.d_ff) == (40, 2560, 6912)
    assert abs(cfg.param_count() - 3.95e9) < 0.01e9


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b", "seamless-m4t-large-v2",
                                  "llama4-scout-17b-a16e", "jamba-1.5-large-398b"])
def test_unported_architectures_are_not_registered(jx, arch):
    jx[2](arch)                               # the JAX package has it
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_config(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_forward_matches_jax(jx, arch):
    jax, jnp, get_config, init_params, forward_train = jx
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), dtype="float32")
    jp = init_params(jax.random.PRNGKey(1), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 33))
    jl, _ = forward_train(jp, cfg, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                                    "targets": jnp.asarray(toks[:, 1:], jnp.int32)})
    tl, _ = tm.forward_train(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :-1]),
                                        "targets": torch.from_numpy(toks[:, 1:])})
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
