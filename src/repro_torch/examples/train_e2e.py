"""End-to-end training: a ~25M-param qwen-family model on the
synthetic corpus, with a checkpoint, a held-out eval and the paper's
compressed-sync option (counterpart of ``examples/train_e2e.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300 \\
        [--sync efbv] [--ckpt results/e2e_ckpt] [--device cpu]

``qwen1.5-4b`` (QKV bias, SwiGLU) with its width cut to ``--d-model`` and
``--layers``; ``--d-model 512 --layers 8`` is the ~100M variant.  The
checkpoint is what ``launch.prune --ckpt`` and ``examples.prune_llm`` read.
"""
from __future__ import annotations

import argparse
import math
from dataclasses import replace


def model_config(d_model: int = 256, layers: int = 4):
    """``qwen1.5-4b`` cut to ``d_model`` x ``layers`` (vocab 8192, f32), as
    ``examples/train_e2e.py`` cuts it."""
    from repro_torch.configs import get_config
    return replace(get_config("qwen1.5-4b"), num_layers=layers, d_model=d_model,
                   num_heads=max(4, d_model // 64), num_kv_heads=max(2, d_model // 128),
                   head_dim=64, d_ff=d_model * 4, vocab_size=8192, dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sync", default="dense",
                    choices=["dense", "efbv", "ef21", "local", "hier"])
    ap.add_argument("--ckpt", default="results/e2e_ckpt")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.launch.prune import lm_loss
    from repro_torch.training.loop import train
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.tree import tree_map

    device = resolve_device(args.device)
    cfg = model_config(args.d_model, args.layers)
    print(f"model: {cfg.num_layers}L d={cfg.d_model} v={cfg.vocab_size} -> "
          f"{cfg.param_count() / 1e6:.1f}M params, sync={args.sync}, on {device}")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=200000, seed=0)
    it = lm_batch_iterator(ds, args.batch, args.seq, seed=1)
    tc = TrainConfig(model=cfg, seq_len=args.seq, global_batch=args.batch, lr=3e-3,
                     warmup_steps=20, total_steps=args.steps,
                     sync=SyncConfig(mode=args.sync, compressor="qsgd", sync_period=4))
    n_groups = 2 if args.sync != "dense" else 1
    state, hist = train(cfg, tc, it, n_groups=n_groups, n_pods=2, steps=args.steps,
                        ckpt_path=args.ckpt, log_every=20, device=device)

    params = state.params
    if args.sync in ("local", "hier"):
        params = tree_map(lambda p: p[0], params)
    eval_it = lm_batch_iterator(ds, args.batch, args.seq, seed=999)
    losses = []
    with torch.no_grad():
        for _ in range(5):
            tokens = torch.as_tensor(next(eval_it)["tokens"], device=device).long()
            losses.append(lm_loss(params, cfg, {"tokens": tokens[:, :-1],
                                                "targets": tokens[:, 1:]}))
    eval_loss = sum(losses) / len(losses)
    print(f"train loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; eval loss "
          f"{eval_loss:.3f} (uniform would be {math.log(cfg.vocab_size):.3f})")
    return {"history": hist, "eval_loss": eval_loss, "cfg": cfg}


if __name__ == "__main__":
    main()
