"""The expert layers' share of the card's bf16 peak: their model flops in
the window (forward + backward of the router, the shared expert and the
held experts' assignments, no recomputation: the window's tokens through
every expert layer, each with the held rows a token-layer had in the
tallies, by the family's ``moe_flops``) over the device time of their spans
(``moe_ms.train``'s, summed over the window) at 989.4 TFLOP/s, in %.  None
where the program has no such span or tally."""
from perf_bench.metrics import counts, moe_tallies


def read(run):
    t = moe_tallies.read(run)
    ms = run.span_ms("model/moe/forward") + run.span_ms("model/moe/backward")
    if t is None or not ms:
        return None
    fam, held_rows, tokens = t
    tr = run.traffic
    token_layers = run.numbers["steps"] * tr["seq_len"] * tr["global_batch"] \
        * run.config["num_layers"]
    flops = 3.0 * fam.moe_flops(run.config, token_layers, token_layers * held_rows / tokens)
    return 100.0 * flops / (sum(ms) / 1e3) / counts.PEAK_FLOPS_BF16
