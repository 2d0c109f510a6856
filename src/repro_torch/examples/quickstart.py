"""Quickstart: train a reduced assigned-arch model with EF-BV compressed
gradient sync, then decode from it (counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch h2o-danube-1.8b] [--steps 150] [--sync efbv] [--device cpu]

The reduced config of the chosen architecture, the synthetic Markov corpus,
the sync mode with the 8-bit quantization compressor (its encoded payload
and modelled round time reported by ``round_comm``), and a short greedy
decode at the end.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--sync", default="efbv", choices=["dense", "efbv", "ef21", "local"])
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.core.distributed import round_comm
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.launch.serve import generate
    from repro_torch.training.loop import train
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_map

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model} "
          f"v={cfg.vocab_size}, {cfg.param_count() / 1e6:.2f}M params) on {device}")
    tc = TrainConfig(model=cfg, seq_len=64, global_batch=8, lr=3e-3,
                     warmup_steps=10, total_steps=args.steps,
                     sync=SyncConfig(mode=args.sync, compressor="qsgd", quant_bits=8))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=60000, seed=0)
    it = lm_batch_iterator(ds, 8, 64, seed=1)
    n_groups = 2 if args.sync != "dense" else 1
    state, hist = train(cfg, tc, it, n_groups=n_groups, n_pods=2, steps=args.steps,
                        log_every=25, device=device)
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    cost = round_comm(tc.sync, cfg.param_count(), device=device)
    print(f"encoded sync payload: {cost.encoded_bits / 8e6:.2f} MB/round "
          f"(dense fp32 would be {cfg.param_count() * 4 / 1e6:.2f} MB); "
          f"modelled round comm on {tc.sync.topology}: {cost.time_s * 1e3:.2f} ms")

    params = state.params
    if args.sync == "local":
        params = tree_map(lambda p: p[0], params)
    prompt = torch.as_tensor(ds.tokens[:32][None].astype("int64"), device=device)
    out = generate(cfg, params, prompt, 16)[0].tolist()
    print("greedy continuation token ids:", out)
    return {"history": hist, "cost": cost, "tokens": out}


if __name__ == "__main__":
    main()
