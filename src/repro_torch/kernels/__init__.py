"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  B1 quant8.quant_dequant_2d        fused absmax quantize + dequantize
  B2 bitpack.quant_pack_2d          quantize to the int8 + scale wire planes
  B3 bitpack.unpack_dequant_2d      wire planes back to dense
  B4 bitpack.pack_mask_2d           presence mask -> 32-bit words
  B5 bitpack.unpack_mask_2d         32-bit words -> presence mask
  B6 stream.stream_quant_pack_2d    B2 through a double-buffered ring
  B7 nm_prune.nm_prune_2d           N:M structured prune by score
  B8 wanda_score.wanda_prune_2d     fused wanda/ria/symwanda score + mask
  D1 delta_apply.delta_apply        a slot's base + pool[table] into its tree

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented only where the CUDA kernel launches;
B8 also counts its selecting launches (``wanda_prune_2d.selecting``).
"""
from repro_torch.kernels import bitpack, delta_apply, nm_prune, quant8, stream, wanda_score

KERNELS = {
    "quant_dequant_2d": quant8.quant_dequant_2d,
    "quant_pack_2d": bitpack.quant_pack_2d,
    "unpack_dequant_2d": bitpack.unpack_dequant_2d,
    "pack_mask_2d": bitpack.pack_mask_2d,
    "unpack_mask_2d": bitpack.unpack_mask_2d,
    "stream_quant_pack_2d": stream.stream_quant_pack_2d,
    "nm_prune_2d": nm_prune.nm_prune_2d,
    "wanda_prune_2d": wanda_score.wanda_prune_2d,
    "delta_apply": delta_apply.delta_apply,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    wanda_score.wanda_prune_2d.selecting = 0
