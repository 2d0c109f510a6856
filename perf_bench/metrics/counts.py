"""Operations and bytes the algorithms need, from the configuration and the
shapes alone (never from what an implementation executes), and the card's
peaks: NVIDIA's H100 SXM data sheet, dense bf16 and HBM3.

Flops count 2 per multiply-add.  A token's forward: every weight product
(attention's or the SSD mixer's projections, the MLP, the output matrix
where logits are needed), causal attention over the positions it sees (its
QK and PV products once, no masked half), the SSD's recurrence over its
state (one multiply-add per state element to update it and one to read it
out).  A training token costs three forwards (the backward two), with no
recomputation counted.  What a layer costs is its family's
(``perf_bench/families/<family>.py``: ``body_weights``, ``mixer_flops``,
``POSITIONAL``).
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989.4e12      # dense bf16, per card
HBM_BYTES_PER_S = 3.35e12


def _family(cfg: dict):
    from perf_bench.harness import bench
    return bench.load_py("families", cfg["family"])


def body_weights(cfg: dict) -> int:
    """Multiply-adds of one token through every layer's weight products."""
    return _family(cfg).body_weights(cfg)


def mixer_flops(cfg: dict, ctx: int) -> float:
    """Flops of one token's sequence mixing at context length ``ctx`` (the
    positions it sees, itself included), all layers."""
    return _family(cfg).mixer_flops(cfg, ctx)


def token_flops(cfg: dict, ctx: int, logits: bool) -> float:
    """One token's forward flops at context ``ctx``."""
    f = 2.0 * body_weights(cfg) + mixer_flops(cfg, ctx)
    if logits:
        f += 2.0 * cfg["d_model"] * cfg["vocab_size"]
    return f


def train_step_flops(cfg: dict, seq_len: int, batch: int) -> float:
    """Forward + backward flops of one step over ``batch`` rows of
    ``seq_len`` tokens, logits at every position."""
    per_row = sum(token_flops(cfg, p + 1, True) for p in range(seq_len)) \
        if _family(cfg).POSITIONAL else seq_len * token_flops(cfg, 1, True)
    return 3.0 * batch * per_row


def b1_bytes(elements: int) -> float:
    """B1 (quantize-dequantize): read x and the draw, write the result, 4 B
    each: 12 B an element."""
    return 12.0 * elements


def b3_bytes(elements: int) -> float:
    """B3 (unpack-dequantize): read the int8 plane, write f32 (5 B an
    element), read a 4 B scale per row of 512."""
    return 5.0 * elements + 4.0 * -(-elements // 512)
