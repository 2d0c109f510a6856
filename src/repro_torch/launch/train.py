"""Training entry point (the CLI of ``repro/launch/train.py`` plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --device cpu --steps 3 --sync efbv     # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 3 --sync efbv --compressor qsgd_kernel   # on the card

Weights are random, from the config's seed; tokens come from
``SyntheticLMDataset`` (seed 0), batches from ``lm_batch_iterator`` (seed 1),
as the JAX launcher feeds them.  ``--dry-run`` (lower and compile on a
multi-pod mesh) and the flags that only feed it (``--shape``,
``--multi-pod``) belong to the multi-GPU slice and raise.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="input shape for --dry-run (not ported)")
    ap.add_argument("--sync", default="dense",
                    choices=["dense", "efbv", "ef21", "diana", "hier", "local"])
    ap.add_argument("--compressor", default="qsgd")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower+compile on the production mesh (not ported)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="mesh for --dry-run (not ported)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    given = [flag for flag, on in (("--dry-run", args.dry_run),
                                   ("--multi-pod", args.multi_pod),
                                   ("--shape", args.shape is not None)) if on]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: lowering the step on a multi-pod mesh is not "
            "ported yet (ROADMAP.md Queue 1, item 8: Multi-GPU)")

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
