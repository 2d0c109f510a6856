"""End-to-end serving example: batched prefill + greedy decode with ragged
requests (counterpart of ``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--arch mamba2-2.7b] [--batch 4] [--gen 24] [--device cpu]

The reduced config of any architecture: requests with prompt lengths of
8-23 tokens are right-aligned into one batch, prefilled once and decoded
step by step, each stopping at token 0.  Encoder-decoder and vision configs
get seeded frame / patch embeddings (``launch.serve.side_inputs``).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import side_inputs
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.obs.trace import wall_s
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_params(0, cfg, device=device)
    rng = np.random.default_rng(0)

    # requests with ragged prompt lengths -> right-aligned into one batch
    lens = rng.integers(8, 24, size=args.batch)
    maxlen = int(lens.max())
    prompts = np.zeros((args.batch, maxlen), np.int64)
    for i, L in enumerate(lens):
        prompts[i, maxlen - L:] = rng.integers(1, cfg.vocab_size, size=L)
    batch = {"tokens": torch.as_tensor(prompts, device=device),
             **side_inputs(cfg, args.batch, 0, device)}

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    t0 = wall_s()
    logits, cache = prefill(params, cfg, batch, cache_len=maxlen + args.gen + 1)
    sync()
    print(f"prefill {args.batch}x{maxlen} in {wall_s() - t0:.2f}s on {device}")

    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    outs = [[] for _ in range(args.batch)]
    done = np.zeros(args.batch, bool)
    t0 = wall_s()
    for _ in range(args.gen):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        for i, t in enumerate(tok[:, 0].tolist()):
            if not done[i]:
                outs[i].append(t)
                done[i] = t == 0            # token 0 as stop
        if done.all():
            break
    dt = wall_s() - t0
    total = sum(len(o) for o in outs)
    print(f"decoded {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on {device})")
    for i, o in enumerate(outs):
        print(f"  req{i} (prompt {lens[i]}): {o[:12]}{'...' if len(o) > 12 else ''}")
    return outs


if __name__ == "__main__":
    main()
