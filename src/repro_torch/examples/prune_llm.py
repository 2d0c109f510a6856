"""SymWanda post-training pruning of a trained reduced LM (Ch. 6):
counterpart of ``examples/prune_llm.py``.

    PYTHONPATH=src python -m repro_torch.examples.prune_llm [--steps 300] \\
        [--ckpt DIR/ckpt] [--device cpu]

Trains reduced ``qwen1.5-4b`` (QKV bias) on the synthetic corpus and saves
its params, then prunes that checkpoint through the pruning CLI
(``launch.prune --ckpt``): magnitude / Wanda / RIA / SymWanda at 50% and 60%
sparsity, Wanda + R^2-DSnoT and Wanda 2:4, each LM loss beside the dense
one.  Without ``--ckpt`` the checkpoint goes to a temporary directory that
is removed at the end.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

ARCH = "qwen1.5-4b"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None, help="where to save the trained params")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.launch import prune
    from repro_torch.training.loop import train
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(ARCH).reduced()
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=60000, seed=0)
    tc = TrainConfig(model=cfg, seq_len=64, global_batch=8, lr=3e-3, warmup_steps=10,
                     total_steps=args.steps)
    tmp = None if args.ckpt else tempfile.mkdtemp()
    path = args.ckpt or os.path.join(tmp, "ckpt")
    try:
        train(cfg, tc, lm_batch_iterator(ds, 8, 64, seed=1), steps=args.steps,
              ckpt_path=path, log_every=100, device=device)
        return prune.main(["--arch", ARCH, "--reduced", "--ckpt", path,
                           "--device", str(device)])
    finally:
        if tmp is not None:
            shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
