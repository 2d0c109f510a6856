"""Training entry point (the CLI of ``repro/launch/train.py`` plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --device cpu --steps 3 --sync efbv     # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 3 --sync efbv --compressor qsgd_kernel   # on the card

Weights are random, from the config's seed; tokens come from
``SyntheticLMDataset`` (seed 0), batches from ``lm_batch_iterator`` (seed 1),
as the JAX launcher feeds them.  ``--dry-run`` hands the process over to
``repro_torch.launch.dryrun`` for the arch, ``--shape`` (default
``train_4k``), the mesh (``--multi-pod``: the (2, 16, 16) one), ``--sync``
and ``--compressor``, as the reference does: the dry-run owns its
process's (fake) process group from the first import.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --dry-run --shape decode_32k --multi-pod       # writes results/dryrun/
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", help="input shape for --dry-run")
    ap.add_argument("--sync", default="dense",
                    choices=["dense", "efbv", "ef21", "diana", "hier", "local"])
    ap.add_argument("--compressor", default="qsgd")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the step on the production mesh instead of running")
    ap.add_argument("--multi-pod", action="store_true", help="the mesh for --dry-run")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    if args.dry_run:
        os.execv(sys.executable, [
            sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", args.arch, "--shape", args.shape,
            "--multi-pod", "multi" if args.multi_pod else "single",
            "--sync", args.sync, "--compressor", args.compressor,
        ])

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.training.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(model=cfg, seq_len=args.seq, global_batch=args.batch,
                     lr=3e-3, warmup_steps=10, total_steps=args.steps,
                     sync=SyncConfig(mode=args.sync, compressor=args.compressor))
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=100000, seed=0)
    it = lm_batch_iterator(ds, args.batch, args.seq, seed=1)
    n_groups = 2 if args.sync != "dense" else 1
    return train(cfg, tc, it, n_groups=n_groups, n_pods=2, steps=args.steps,
                 ckpt_path=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
