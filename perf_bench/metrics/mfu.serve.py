"""Useful model flops over the window times 989.4 TFLOP/s, in %: each
prompt token of a request admitted in the window once (no logits but the
last), each served token once at its context length; the re-prefill of
running contexts at a refill is recomputation and left out."""
from perf_bench.metrics import counts


def read(run):
    cfg = run.config
    f = sum(counts.token_flops(cfg, p + 1, False)
            for n in run.series["prompt_lens"] for p in range(n - 1))
    f += sum(counts.token_flops(cfg, c, True) for c in run.series["token_ctx"])
    return 100.0 * f / run.window_s / counts.PEAK_FLOPS_BF16
