"""Greedy-decode entry point: prefill a batch of random prompts, then decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --reduced --batch 2 --gen 8            # on the card
  ... --device cpu                           # on the CPU

Weights are random, from ``--seed``.  Logits are trimmed to ``vocab_size``
before the argmax.  (The JAX launcher's ``--dry-run`` is TPU tooling and is
not ported.)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def generate(cfg, params, prompt: torch.Tensor, gen: int) -> np.ndarray:
    """Greedy decode ``gen`` tokens after ``prompt`` (B, L) -> (B, gen)."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(params, cfg, {"tokens": prompt},
                            cache_len=prompt.shape[1] + gen + 1)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks = []
    for _ in range(gen):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, 1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

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
    out = generate(cfg, params, prompt, args.gen)
    print("decoded:", out.tolist())
    return out


if __name__ == "__main__":
    main()
