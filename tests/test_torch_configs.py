"""The port's configs (``repro_torch/configs``) against the JAX package's:
all ten registered (and ``PORT_ONLY``, the port's own architectures), every
field of the JAX package's equal and each field only the port has at its
default (a no-op), ``param_count``, ``active_param_count``,
``padded_vocab`` and ``reduced()`` equal, and the full-sequence forward of
each dense ``reduced()`` config (f32) within atol 2e-5 of
``repro.models.forward_train`` from the same parameters (the port's
attention is one masked softmax where JAX tiles it; matmuls sum in another
order).  The MoE, Mamba, hybrid and encoder-decoder forwards are held in
``tests/test_torch_arch.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs as t_list_configs
from repro_torch.interop import params_from_jax

torch.set_num_threads(2)
ATOL = 2e-5
DENSE = ("chameleon-34b", "h2o-danube-1.8b", "nemotron-4-15b", "qwen1.5-110b", "qwen1.5-4b")
OTHER = ("dbrx-132b", "jamba-1.5-large-398b", "llama4-scout-17b-a16e", "mamba2-2.7b",
         "seamless-m4t-large-v2")
# architectures the JAX package lacks (held to a plain reference instead:
# tests/test_torch_granite.py)
PORT_ONLY = ("granite-4.0-h-small",)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import forward_train, init_params
    return jax, jnp, get_config, init_params, forward_train


def test_the_port_registers_the_five_dense_configs():
    """... and every other config of the JAX package, and exactly
    ``PORT_ONLY`` besides."""
    from repro.configs import list_configs
    assert sorted(DENSE + OTHER) == list_configs()
    assert t_list_configs() == sorted(DENSE + OTHER + PORT_ONLY)


def _port_fields(tcfg, cfg) -> dict:
    """The port config's fields as a dict: the JAX package's fields (nested
    sub-configs too) as they are, and every field only the port has checked
    to hold its default and left out."""
    def walk(t, j):
        if not dataclasses.is_dataclass(t):
            return t
        out = {}
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if f.name in {g.name for g in dataclasses.fields(j)}:
                jv = getattr(j, f.name)
                out[f.name] = walk(v, jv) if dataclasses.is_dataclass(jv) else \
                    dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            else:
                assert v == f.default, (t.__class__.__name__, f.name, v)
        return out
    return walk(tcfg, cfg)


@pytest.mark.parametrize("arch", DENSE + OTHER)
def test_fields_and_param_count_match_jax(jx, arch):
    get_config = jx[2]
    cfg, tcfg = get_config(arch), t_get_config(arch)
    assert _port_fields(tcfg, cfg) == dataclasses.asdict(cfg)
    assert tcfg.param_count() == cfg.param_count()
    assert tcfg.active_param_count() == cfg.active_param_count()
    assert tcfg.padded_vocab() == cfg.padded_vocab()
    assert _port_fields(tcfg.reduced(), cfg.reduced()) == dataclasses.asdict(cfg.reduced())
    r, tr = cfg.reduced(), tcfg.reduced()
    assert (tr.param_count(), tr.active_param_count(), tr.padded_vocab()) == \
        (r.param_count(), r.active_param_count(), r.padded_vocab())


def test_qwen1_5_4b_at_full_width():
    cfg = t_get_config("qwen1.5-4b")
    assert cfg.qkv_bias and (cfg.num_layers, cfg.d_model, cfg.d_ff) == (40, 2560, 6912)
    assert abs(cfg.param_count() - 3.95e9) < 0.01e9


@pytest.mark.parametrize("arch,params,active", [
    ("mamba2-2.7b", 2_702_393_856, 2_702_393_856),
    ("seamless-m4t-large-v2", 2_034_783_232, 2_034_783_232),
])
def test_full_size_counts_of_the_models_served_whole(arch, params, active):
    """The two configs the card runs at full size, by ``param_count``."""
    cfg = t_get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (params, active)


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
