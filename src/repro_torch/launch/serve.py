"""Greedy-decode entry point: prefill a batch of random prompts, then decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --reduced --batch 2 --gen 8            # on the card
  ... --device cpu                           # on the CPU

Weights are random, from ``--seed``; so are the encoder's frame embeddings
(encoder-decoder configs) and the vision stub's patch embeddings (vision
configs), each from its own seeded generator.  Logits are trimmed to
``vocab_size`` before the argmax.  ``--dry-run`` hands the process over to
``repro_torch.launch.dryrun`` for the arch, the serving ``--shape``
(default ``decode_32k``) and the mesh (``--multi-pod``: the (2, 16, 16)
one), as the reference does and as ``launch.train --dry-run`` does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --dry-run --shape decode_32k --multi-pod      # writes results/dryrun/
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def generate(cfg, params, prompt: torch.Tensor, gen: int, src_embeds=None,
             vision_embeds=None) -> np.ndarray:
    """Greedy decode ``gen`` tokens after ``prompt`` (B, L) -> (B, gen).
    ``src_embeds`` (B, S_src, De) feeds the encoder and ``vision_embeds``
    (B, nv, D) the vision stub, where the config has them."""
    from repro_torch.models import decode_step, prefill

    batch = {"tokens": prompt}
    if src_embeds is not None:
        batch["src_embeds"] = src_embeds
    if vision_embeds is not None:
        batch["vision_embeds"] = vision_embeds
    logits, cache = prefill(params, cfg, batch, cache_len=prompt.shape[1] + gen + 1)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks = []
    for _ in range(gen):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, 1).cpu().numpy()


def side_inputs(cfg, batch: int, seed: int, device, src_len: int = 16) -> dict:
    """0.02 * N(0, 1) frame embeddings (B, src_len, De) and patch embeddings
    (B, nv, D) for the configs that take them, from generators seeded with
    ``seed + 1`` and ``seed + 2`` (the JAX launcher's keys 1 and 2; not its
    values)."""
    from repro_torch.utils.device import make_generator

    out = {}
    if cfg.enc_layers:
        g = make_generator(seed + 1, device)
        out["src_embeds"] = 0.02 * torch.randn(
            (batch, src_len, cfg.enc_d_model or cfg.d_model), generator=g, device=device)
    if cfg.vision_tokens:
        g = make_generator(seed + 2, device)
        out["vision_embeds"] = 0.02 * torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=g, device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k",
                    choices=["prefill_32k", "decode_32k", "long_500k"],
                    help="input shape for --dry-run")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the serving step on the production mesh instead of running")
    ap.add_argument("--multi-pod", action="store_true", help="the mesh for --dry-run")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.dry_run:
        os.execv(sys.executable, [
            sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", args.arch, "--shape", args.shape,
            "--multi-pod", "multi" if args.multi_pod else "single",
        ])

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(args.seed, cfg, device=device)
    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (args.batch, 16)),
                             device=device)
    out = generate(cfg, params, prompt, args.gen,
                   **side_inputs(cfg, args.batch, args.seed, device))
    print("decoded:", out.tolist())
    return out


if __name__ == "__main__":
    main()
