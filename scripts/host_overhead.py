"""Host-bound times of the port's plain (single-device) model path, for
comparing two source trees in one run on one card.

The decode step and the short-sequence train step of a full-width model are
bound by the host's dispatch, not the card: a change to the Python around
each op shows here first.  Times three things per model, each the median of
``--reps`` runs after two warm-up runs, on the host's clock with the card
synchronized:

* ``fwd_bwd``: ``loss_fn`` + ``torch.autograd.grad`` at (2, 64) tokens,
  remat full (chip_smoke's train phase's shape);
* ``prefill``: ``prefill`` of (1, 16) tokens;
* ``decode``: one ``decode_step`` of a (1, 1) token against that cache.

Usage (repeat the trees as A, B, B, A, as the card's clocks drift):
  python scripts/host_overhead.py --src src [--src /path/to/other/src ...]
Prints one JSON line per tree.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MODELS = ("h2o-danube-1.8b", "mamba2-2.7b")


def _median_ms(fn, sync, reps: int) -> float:
    for _ in range(2):
        fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def measure(reps: int) -> dict:
    import torch
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    out = {}
    for arch in MODELS:
        cfg = get_config(arch)
        params = tm.init_params(0, cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev,
                            dtype=torch.int32)
        batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
        leaves, td = tree_flatten(params)

        def fwd_bwd():
            req = [x.detach().requires_grad_(True) for x in leaves]
            loss, _ = tm.loss_fn(tree_unflatten(td, req), cfg, batch, remat="full")
            torch.autograd.grad(loss, req)

        row = {"fwd_bwd": _median_ms(fwd_bwd, sync, reps)}
        prompt = {"tokens": tok[:1, :16]}
        with torch.no_grad():
            _, cache = tm.prefill(params, cfg, prompt, cache_len=64)
            token = tok[:1, 16:17]

            def decode():
                cache["pos"] = 16
                tm.decode_step(params, cfg, token, cache)

            row["prefill"] = _median_ms(lambda: tm.prefill(params, cfg, prompt, cache_len=64),
                                        sync, reps)
            row["decode"] = _median_ms(decode, sync, reps)
        out[arch] = {k: round(v, 3) for k, v in row.items()}
        del params, leaves, cache
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", help="a source tree holding repro_torch")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        sys.path.insert(0, args.one)
        print(json.dumps({"src": args.one, "ms": measure(args.reps)}))
        return
    for src in args.src or ["src"]:
        src = os.path.abspath(src)
        r = subprocess.run([sys.executable, __file__, "--one", src, "--reps", str(args.reps)],
                           capture_output=True, text=True, check=True,
                           env=dict(os.environ, PYTHONPATH=src))
        print(r.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
