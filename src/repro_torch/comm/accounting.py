"""Round-level communication accounting on top of the codecs + topology.

Replaces the ad-hoc analytic bits computations that each algorithm carried
(``distributed.bits_per_round``, per-bench counters): byte counts come from
*encoding an actual payload* with the configured compressor's codec, and the
topology simulator turns them into per-round wall-clock.

Measured sizes are obtained on a probe tensor.  For models larger than the
probe cap the VALUE planes scale linearly (bits per kept coordinate are
constant for every registered compressor), while the index-side planes —
uint32 indices, bitpacked block-local indices, per-block counts, bitmap
words, quantizer scales — are sized analytically from the true dimension
(``codecs.extrapolate_bits``): a uint32 index plane is 32 bits per kept
coordinate no matter how large d grows, whereas block-granular planes grow
with d's block count, so pure linear scaling misstates sparse payloads.

(The port of ``repro/comm/accounting.py``.  The probe is drawn from a seeded
``torch.Generator`` on ``device`` and encoded by the port's own
``codecs.encode``, so a ``qsgd_kernel`` probe packs through kernel B2 on the
card.  Byte counts equal the JAX package's; every time here is a model of
the named topology preset, never a time measured on the card.)

Hierarchical modes are costed per aggregation level: ``hier`` (with or
without ``SyncConfig.levels``) runs through the tree path, so a ``RoundCost``
carries one ``LevelCost`` per level and a per-round ledger can tag every
record with its level name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.comm import codecs
from repro_torch.comm.ledger import RETRY_TAG, CommLedger
from repro_torch.comm.topology import (DEFAULT_PROFILE, DEFAULT_TILE_BYTES,
                                       CodecProfile, Topology, get_topology)
from repro_torch.comm.tree import TreeTopology, get_tree_topology
from repro_torch.utils.device import make_generator, resolve_device

PROBE_CAP = 1 << 20  # max coordinates actually encoded when sizing a round


@dataclass(frozen=True)
class LevelCost:
    """One aggregation-tree level's share of a sync round (per child node)."""
    name: str
    fanout: int
    period: int
    compressor: str
    link_gbps: float
    bytes_per_round: float   # encoded bytes, amortized over the level period
    time_s: float            # amortized simulated time (streamed if enabled)
    serial_time_s: float     # amortized monolithic pack -> ring -> unpack
    retry_bytes: float = 0.0      # expected retransmitted bytes (faults)
    degraded_time_s: float = 0.0  # straggler order-stat time, deadline-capped


@dataclass(frozen=True)
class RoundCost:
    """One synchronization round, per worker: encoded traffic + simulated time."""
    mode: str
    n_params: int
    intra_bytes: float       # fast-fabric bytes per device per round (tree
                             # modes: the leaf level's share)
    inter_bytes: float       # slow-link bytes per device per round (tree
                             # modes: every level above the leaves)
    time_s: float            # simulated wall-clock of the round (streamed
                             # pipeline when tile_bytes > 0, else serial)
    encoded_bits: float      # per-node payload bits per round (amortized)
    analytic_bits: float     # the seed's closed-form model (cross-check)
    serial_time_s: float = 0.0   # monolithic pack -> send -> unpack wall-clock
    tile_bytes: int = 0          # streamed transport tile (0 = monolithic)
    levels: Tuple[LevelCost, ...] = ()  # per-level attribution (hier modes)
    retry_bytes: float = 0.0     # expected retransmitted bytes (fault model;
                                 # the ledger charges these under tag "retry")
    degraded_time_s: float = 0.0  # expected round time under stragglers/
                                  # deadlines (order statistics, not the mean)

    @property
    def total_bytes(self) -> float:
        return self.intra_bytes + self.inter_bytes + self.retry_bytes

    @property
    def stream_speedup(self) -> float:
        return self.serial_time_s / self.time_s if self.time_s > 0 else 1.0


def payload_bits_for(c, n_params: int, seed: int = 0, device=None) -> float:
    """Measured wire bits of one message from compressor ``c`` at dim
    ``n_params`` (probe-capped; index planes sized analytically beyond).
    The probe and the compressor's draws come from one generator seeded
    with ``seed`` on ``device`` (``None`` -> the card)."""
    device = resolve_device(device)
    gen = make_generator(seed, device)
    probe_d = min(int(n_params), PROBE_CAP)
    x = torch.randn(probe_d, generator=gen, device=device)
    p = codecs.encode(c, x, generator=gen)
    if probe_d == int(n_params):
        return float(p.nbits)
    return codecs.extrapolate_bits(p, probe_d, int(n_params))


def measured_payload_bits(sync, n_params: int, seed: int = 0,
                          device=None) -> float:
    """Encode a probe gradient with the configured compressor; exact bits."""
    from repro_torch.core.distributed import build_compressor

    return payload_bits_for(build_compressor(sync), n_params, seed=seed,
                            device=device)


def _hier_levels(sync):
    """The level configs of a hier round: ``SyncConfig.levels`` verbatim, or
    the classic two-level schedule (dense intra every step + compressed inter
    every sync_period) when unset."""
    from repro_torch.configs.base import LevelConfig

    if getattr(sync, "levels", None):
        return tuple(sync.levels)
    return (LevelConfig("intra", period=1, compressor="identity"),
            LevelConfig("inter", period=max(1, sync.sync_period),
                        compressor=sync.compressor,
                        compress_ratio=sync.compress_ratio,
                        quant_bits=sync.quant_bits))


def _hier_tree(sync, topology: Optional[Topology]) -> TreeTopology:
    if isinstance(topology, TreeTopology):
        return topology
    if topology is not None:
        return TreeTopology.from_flat(topology)
    return get_tree_topology(getattr(sync, "topology", "v5p_superpod"))


def _level_costs(sync, n_params: int, tree: TreeTopology, tile_bytes: int,
                 seed: int = 0, device=None, profile: Optional[CodecProfile] = None,
                 faults=None) -> Tuple[LevelCost, ...]:
    """Per-level byte/time attribution of one tree round (per child node).
    ``profile`` overrides every compressed level's codec profile; ``faults``
    (a ``FaultConfig``) adds expected retransmission bytes and the
    deadline-capped straggler order-statistic time per level."""
    from repro_torch.core.distributed import make_sync_compressor

    lcfgs = _hier_levels(sync)
    if len(lcfgs) != len(tree.levels):
        raise ValueError(
            f"sync has {len(lcfgs)} levels but tree topology {tree.name!r} "
            f"has {len(tree.levels)}")
    faulty = faults is not None and faults.enabled()
    out = []
    for l, (lc, tl) in enumerate(zip(lcfgs, tree.levels)):
        period = max(1, lc.period)
        if lc.compressor == "identity":
            enc_bytes = 4.0 * n_params         # dense fp32, no codec
            serial = tree.ring_time_s(l, enc_bytes)
            stream = serial
        else:
            c = make_sync_compressor(lc.compressor, lc.compress_ratio,
                                     lc.quant_bits)
            enc_bytes = payload_bits_for(c, n_params, seed=seed,
                                         device=device) / 8.0
            serial = tree.level_serial_time_s(l, enc_bytes, profile=profile)
            stream = (tree.level_stream_time_s(l, enc_bytes, tile_bytes,
                                               profile=profile)
                      if tile_bytes > 0 else serial)
        retry_b = degraded = 0.0
        if faulty:
            lf = tree.level_faults(l, faults)
            e_tx = faults.expected_transmissions(lf.loss_rate)
            retry_b = (e_tx - 1.0) * enc_bytes / period
            degraded = tree.level_degraded_time_s(
                l, enc_bytes, faults, codec=lc.compressor != "identity",
                profile=profile) / period
        out.append(LevelCost(tl.name, tl.fanout, period, lc.compressor,
                             tl.link.gbps, enc_bytes / period,
                             stream / period, serial / period,
                             retry_bytes=retry_b, degraded_time_s=degraded))
    return tuple(out)


def round_cost(sync, n_params: int, topology=None, seed: int = 0,
               device=None, profile: Optional[CodecProfile] = None) -> RoundCost:
    """Per-round, per-worker communication of one sync mode.

    dense       every round: full fp32 payload on the slow links
    efbv/ef21/diana  every round: encoded compressed delta on the slow links
    local       full fp32 payload every sync_period rounds (amortized)
    hier        per aggregation-tree level: an encoded delta every
                ``period[l]`` rounds on level l's link (Cohort-Squeeze); the
                classic intra/inter schedule is the depth-2 special case

    Compressed payloads pay the codec: ``serial_time_s`` is the monolithic
    pack -> collective -> unpack sum; ``time_s`` is the streamed pipeline
    (``SyncConfig.stream_tile_bytes``-sized tiles overlapping the three
    stages) when streaming is enabled, otherwise the serial time.
    """
    from repro_torch.core.distributed import build_compressor

    tile_bytes = int(getattr(sync, "stream_tile_bytes", DEFAULT_TILE_BYTES))
    dense_bytes = 4.0 * n_params

    faults = getattr(sync, "faults", None)
    if sync.mode == "hier":
        tree = _hier_tree(sync, topology)
        lvls = _level_costs(sync, n_params, tree, tile_bytes, seed=seed,
                            device=device, profile=profile, faults=faults)
        intra = lvls[0].bytes_per_round
        inter = sum(lv.bytes_per_round for lv in lvls[1:])
        serial_s = sum(lv.serial_time_s for lv in lvls)
        stream_s = sum(lv.time_s for lv in lvls)
        retry_b = sum(lv.retry_bytes for lv in lvls)
        degraded_s = sum(lv.degraded_time_s for lv in lvls)
        # the paper's per-node bits metric: every compressed level, plus
        # dense non-leaf levels (fp32 on a real link); the leaf level's dense
        # fabric sync is the one hop it excludes
        bits = sum(8.0 * lv.bytes_per_round for l, lv in enumerate(lvls)
                   if l > 0 or lv.compressor != "identity")
        analytic = 0.0
        from repro_torch.core.distributed import make_sync_compressor
        for l, lc in enumerate(_hier_levels(sync)):
            if l == 0 and lc.compressor == "identity":
                continue
            c = make_sync_compressor(lc.compressor, lc.compress_ratio,
                                     lc.quant_bits)
            analytic += codecs.analytic_bits(c, n_params) / max(1, lc.period)
        return RoundCost(sync.mode, n_params, intra, inter,
                         stream_s if tile_bytes > 0 else serial_s,
                         bits, analytic, serial_time_s=serial_s,
                         tile_bytes=max(0, tile_bytes), levels=lvls,
                         retry_bytes=retry_b, degraded_time_s=degraded_s)

    topo = topology or get_topology(getattr(sync, "topology", "v5p_superpod"))
    if isinstance(topo, TreeTopology):
        raise ValueError(f"mode {sync.mode!r} takes a flat Topology")
    period = max(1, sync.sync_period)
    prof = profile or DEFAULT_PROFILE
    if sync.mode in ("dense", "local"):
        enc_bits = 32.0 * n_params  # fp32 on the wire, no compressor
    else:
        enc_bits = measured_payload_bits(sync, n_params, seed=seed,
                                         device=device)
    enc_bytes = enc_bits / 8.0

    if sync.mode == "dense":
        intra, inter = 0.0, dense_bytes
        serial_s = stream_s = topo.allreduce_time_s(dense_bytes, scope="global")
        bits = 8.0 * dense_bytes
    elif sync.mode in ("efbv", "ef21", "diana"):
        intra, inter = 0.0, enc_bytes
        serial_s = topo.allreduce_serial_time_s(enc_bytes, "global", prof)
        stream_s = (topo.allreduce_stream_time_s(enc_bytes, "global",
                                                 tile_bytes, prof)
                    if tile_bytes > 0 else serial_s)
        bits = enc_bits
    elif sync.mode == "local":
        intra, inter = 0.0, dense_bytes / period
        serial_s = stream_s = (
            topo.allreduce_time_s(dense_bytes, scope="global") / period)
        bits = 8.0 * dense_bytes / period
    else:
        raise KeyError(f"unknown sync mode {sync.mode!r}")

    c = build_compressor(sync)
    analytic = codecs.analytic_bits(c, n_params)
    if sync.mode == "local":
        analytic = 32.0 * n_params / period
    if sync.mode == "dense":
        analytic = 32.0 * n_params  # fp32, no compressor on the wire
    # codec-free modes (dense/local fp32 wires) have nothing to stream:
    # report tile_bytes=0 so consumers don't claim a pipeline that isn't there
    if sync.mode in ("dense", "local"):
        tile_bytes = 0
    retry_b = degraded_s = 0.0
    if faults is not None and faults.enabled():
        # flat modes: the slow inter link is the faulty one (depth-1 view)
        from repro_torch.comm.topology import straggler_level_time_s

        lf = faults.link_faults("inter")
        e_tx = faults.expected_transmissions(lf.loss_rate)
        retry_b = (e_tx - 1.0) * inter
        degraded_s = straggler_level_time_s(
            serial_s * e_tx + faults.backoff_s * (e_tx - 1.0),
            faults.straggler_rate, faults.straggler_sigma, topo.n_pods,
            faults.level_deadline_s("inter"))
    return RoundCost(sync.mode, n_params, intra, inter,
                     stream_s if tile_bytes > 0 else serial_s,
                     bits, analytic, serial_time_s=serial_s,
                     tile_bytes=max(0, tile_bytes),
                     retry_bytes=retry_b, degraded_time_s=degraded_s)


def round_ledger(sync, n_params: int, n_rounds: Optional[int] = None,
                 topology=None, seed: int = 0, device=None) -> CommLedger:
    """CommLedger of a hier/tree schedule: one record per level per sync
    step, tagged with the level name (phase = level index, so the cascade's
    bottom-up dependency shows up in the round timing model).

    Defaults to one full root period of rounds, over which the per-level
    record bytes average exactly to ``RoundCost.total_bytes`` per round.
    With ``SyncConfig.faults`` enabled, each sync step additionally charges
    the expected retransmitted bytes under tag ``"retry"`` — disabled or
    absent faults add no records at all (bit-identical ledger totals).
    """
    if sync.mode != "hier":
        raise ValueError("round_ledger models hier/tree schedules")
    tree = _hier_tree(sync, topology)
    tile_bytes = int(getattr(sync, "stream_tile_bytes", DEFAULT_TILE_BYTES))
    faults = getattr(sync, "faults", None)
    lvls = _level_costs(sync, n_params, tree, tile_bytes, seed=seed,
                        device=device, faults=faults)
    if n_rounds is None:
        n_rounds = lvls[-1].period
    led = CommLedger()
    for t in range(n_rounds):
        for l, lv in enumerate(lvls):
            if (t % lv.period) != (lv.period - 1):
                continue
            kind = "intra" if l == 0 else "inter"
            led.record(t, f"{lv.name}->up", round(lv.bytes_per_round * lv.period),
                       kind=kind, phase=l, tag=lv.name)
            if lv.retry_bytes > 0:
                led.record(t, f"{lv.name}->up",
                           round(lv.retry_bytes * lv.period),
                           kind=kind, phase=l, tag=RETRY_TAG)
    return led


def round_bits(sync, n_params: int, device=None) -> float:
    """Per-round, per-node encoded payload bits (the Fig 2.2 y-axis unit).

    This is what ``distributed.bits_per_round`` now wraps: measured from the
    codec's packed buffers, amortized over the sync period per mode.
    """
    return round_cost(sync, n_params, device=device).encoded_bits
