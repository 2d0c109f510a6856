"""The port's tiled (flash) attention against the reference's
``repro.models.attention._flash_attention``, from the same inputs (numpy,
seeded).

Tolerances: outputs within atol 2e-5 (the reference's own bound against a
naive softmax, ``tests/test_models_units.py``; the two packages' matmuls sum
in another order); gradients (dq, dk, dv, against ``jax.grad`` through the
reference) within atol 5e-5 (the same sums, taken in the backward's order on
each side).  The bytes autograd saves for the backward grow linearly in S,
and no prefill, train, encoder or cross-attention path reaches ``_attend``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattn
from repro_torch.utils.tree import tree_flatten

torch.set_num_threads(2)
ATOL, GRAD_ATOL = 2e-5, 5e-5
B, H, KV, HD = 2, 4, 2, 16
KINDS = [("attn", 0, 0), ("attn_swa", 8, 0), ("attn_chunk", 0, 16), ("full", 0, 0)]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    return jax, jnp, jattn


def _inputs(seed, Sq, Sk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, HD)).astype(np.float32)
    cot = rng.standard_normal((B, Sq, H, HD)).astype(np.float32)
    return q, k, v, cot


class _Banded:
    """Set ``BANDED`` on both packages' attention modules for a block."""

    def __init__(self, jattn, on):
        self.mods, self.on = (jattn, tattn), on

    def __enter__(self):
        self.old = [m.BANDED for m in self.mods]
        for m in self.mods:
            m.BANDED = self.on

    def __exit__(self, *exc):
        for m, o in zip(self.mods, self.old):
            m.BANDED = o


def _both(jx, q, k, v, cot, kind, window, chunk, q_offset=0, bq=16, bk=16):
    """-> ((out, dq, dk, dv) of the reference, the same of the port), numpy."""
    jax, jnp, jattn = jx

    def f(q_, k_, v_):
        return jattn._flash_attention(q_, k_, v_, kind, window, chunk, q_offset=q_offset,
                                      block_q=bq, block_k=bk)

    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = tattn._flash_attention(tq, tk, tv, kind, window, chunk, q_offset=q_offset,
                                  block_q=bq, block_k=bk)
    tout.backward(torch.from_numpy(cot))
    ref = [np.asarray(jout)] + [np.asarray(g) for g in jgrads]
    port = [tout.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    return ref, port


def _check(ref, port):
    np.testing.assert_allclose(port[0], ref[0], atol=ATOL, rtol=0)
    for name, r, p in zip(("dq", "dk", "dv"), ref[1:], port[1:]):
        np.testing.assert_allclose(p, r, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("S", [24, 64])
@pytest.mark.parametrize("kind,window,chunk", KINDS)
def test_tiled_attention_matches_reference(jx, kind, window, chunk, S, banded):
    q, k, v, cot = _inputs(S, S, S)
    with _Banded(jx[2], banded):
        ref, port = _both(jx, q, k, v, cot, kind, window, chunk)
    _check(ref, port)


@pytest.mark.parametrize("kind,window,chunk", KINDS)
def test_ragged_length_pads_and_masks(jx, kind, window, chunk):
    """S = 37 over 16 x 16 tiles: the q and kv padding, and the pad mask on
    the padded keys."""
    q, k, v, cot = _inputs(37, 37, 37)
    ref, port = _both(jx, q, k, v, cot, kind, window, chunk)
    _check(ref, port)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("kind,window,chunk", KINDS[:3])
def test_q_offset(jx, kind, window, chunk, banded):
    """24 queries at positions 16..39 against 40 keys (a continued prompt),
    and 20 queries at 30..49 against 37 keys (queries past the last key: the
    skipping of masked blocks must not apply)."""
    for Sq, Sk, off in ((24, 40, 16), (20, 37, 30)):
        q, k, v, cot = _inputs(Sq + off, Sq, Sk)
        with _Banded(jx[2], banded):
            ref, port = _both(jx, q, k, v, cot, kind, window, chunk, q_offset=off)
        _check(ref, port)


@pytest.mark.parametrize("kind,window,chunk,S", [
    ("attn_swa", 24, 0, 96), ("attn_chunk", 0, 32, 96), ("attn_swa", 8, 0, 64),
    ("attn_chunk", 0, 16, 40)])
def test_banded_windows_wider_than_a_block(jx, kind, window, chunk, S):
    """The reference's banded cases, bq = bk = 16, both settings."""
    q, k, v, cot = _inputs(S + window, S, S)
    for banded in (False, True):
        with _Banded(jx[2], banded):
            ref, port = _both(jx, q, k, v, cot, kind, window, chunk)
        _check(ref, port)


def test_unequal_tiles(jx):
    """bq != bk (the reference's 512 x 1024 shape, scaled down)."""
    q, k, v, cot = _inputs(5, 70, 70)
    for banded in (False, True):
        with _Banded(jx[2], banded):
            ref, port = _both(jx, q, k, v, cot, "attn_swa", 20, 0, bq=8, bk=16)
        _check(ref, port)


def test_plan_visits_only_reachable_blocks():
    """Unbanded, the plan drops the blocks above the causal diagonal and the
    wholly masked ones before an SWA window; "full" visits every block."""
    p = tattn._plan(64, 64, "attn", 0, 0, 0, 16, 16)
    assert [[ki for ki, _ in t] for t in p.tiles] == [[0], [0, 1], [0, 1, 2], [0, 1, 2, 3]]
    p = tattn._plan(64, 64, "attn_swa", 16, 0, 0, 16, 16)
    assert [[ki for ki, _ in t] for t in p.tiles] == [[0], [0, 1], [1, 2], [2, 3]]
    p = tattn._plan(37, 37, "full", 0, 0, 0, 16, 16)
    assert [[c for _, c in t] for t in p.tiles] == [["all", "all", "some"]] * 3


def _saved_bytes(S):
    q = torch.randn((1, S, H, HD), requires_grad=True)
    k = torch.randn((1, S, KV, HD), requires_grad=True)
    v = torch.randn((1, S, KV, HD), requires_grad=True)
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn._flash_attention(q, k, v, "attn", 0, 0, block_q=64, block_k=64)
    out.sum().backward()
    return sum(total)


def test_saved_bytes_grow_linearly():
    """What autograd keeps for the backward is O(S): q, k, v, the f32 output
    and two f32 row statistics; at fixed 64 x 64 tiles, 4x the length saves
    4x the bytes (the whole score matrix would save 16x)."""
    small, big = _saved_bytes(256), _saved_bytes(1024)
    per_row = 4 * (H * HD + 2 * KV * HD) + 4 * H * HD + 8 * H
    assert small == 256 * per_row and big == 1024 * per_row


def test_no_prefill_train_or_encoder_path_reaches_attend(monkeypatch):
    """Prefill, forward_train (with its backward), the encoder and the
    cross-attention all run the tiled path; ``_attend`` serves decode only."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config

    def refuse(*a, **kw):
        raise AssertionError("_attend reached")

    for arch in ("h2o-danube-1.8b", "seamless-m4t-large-v2"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = tm.init_params(0, cfg, device="cpu")
        toks = torch.randint(1, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(0))
        batch = {"tokens": toks, "targets": toks}
        if cfg.enc_layers:
            batch["src_embeds"] = torch.randn((1, 10, cfg.enc_d_model or cfg.d_model))
        monkeypatch.setattr(tattn, "_attend", refuse)
        _, cache = tm.prefill(params, cfg, batch)
        leaves = [p.requires_grad_(True) for p in tree_flatten(params)[0]]
        loss, _ = tm.loss_fn(params, cfg, batch)
        loss.backward()
        wq = params["blocks"]["pos0"]["attn"]["wq"]
        assert wq.grad is not None and bool(torch.isfinite(wq.grad).all())
        for p in leaves:
            p.requires_grad_(False)
        monkeypatch.undo()
        tm.decode_step(params, cfg, toks[:, :1], cache)     # decode does use _attend
