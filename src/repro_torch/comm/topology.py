"""Link-topology simulator: cross-device vs cross-pod bandwidth/latency.

(The port's copy of ``repro/comm/topology.py``.  Every time it yields is a
model of the named preset's links, never a time measured on the card.)

The paper's communication-efficiency story is about *heterogeneous* links:
Cohort-Squeeze (Ch. 5) pays c_local per intra-cluster round and c_global per
cross-cluster round and shows K > 1 local rounds win whenever
c_global >> c_local.  This module gives those abstract costs physical units:
a ``Topology`` holds one fast fabric link class ("intra": ICI/NVLink-scale)
and one slow one ("inter": DCN / WAN / federated edge), and converts message
or collective sizes into seconds.

Collective model (ring): an all-reduce over g participants moves
2*(g-1)/g * nbytes per device in 2*(g-1) latency-bound steps; reduce and
broadcast/gather halves are (g-1)/g each.  This matches how
launch/hlo_analysis.py counts per-device collective payload, so simulated
times compose with the HLO-derived byte totals in launch/costing.py.

The streaming extension models the *pipelined* transport the codecs feed
(``codecs.encode_stream`` / the Pallas DMA ring in ``kernels/stream.py``):
pack, send, and unpack run as a 3-stage pipeline over fixed-size tiles, so a
round costs fill (one tile through every stage) plus steady state paced by
the slowest stage — ``max(pack, send, unpack)`` per tile — instead of the
serial ``pack + send + unpack`` sum the monolithic codec pays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence

DEFAULT_TILE_BYTES = 1 << 20  # streamed transport tile (bytes on the wire)


# ---------------------------------------------------------------------------
# straggler order statistics — expected round time under deadlines
# ---------------------------------------------------------------------------
def norm_ppf(p: float) -> float:
    """Standard-normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9 — no scipy in the image)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p={p} outside (0, 1)")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5])
                 / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = p - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
             * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
               * r + 1))


def straggler_scale_quantile(q: float, rate: float, sigma: float) -> float:
    """Quantile of one child's slowdown multiplier under the mixture
    ``(1-rate) * point_mass(1) + rate * exp(sigma * |N(0,1)|)``."""
    if q <= 1 - rate or rate <= 0 or sigma <= 0:
        return 1.0
    # |z| has CDF 2*Phi(z)-1; invert the mixture's straggler branch
    inner = min(1.0 - 1e-12, (q - (1 - rate)) / rate)
    z = norm_ppf((1.0 + inner) / 2.0)
    return math.exp(sigma * max(0.0, z))


def straggler_level_time_s(base_s: float, rate: float, sigma: float,
                           n: int, deadline_s: float = math.inf) -> float:
    """Expected completion time of a level waiting on ``n`` children.

    The level finishes at the MAX of n iid slowdown multipliers times
    ``base_s`` — an order statistic, not the mean: the median of the max is
    the per-child quantile ``q = 0.5 ** (1/n)``.  A finite deadline caps it
    (the aggregator stops waiting): ``min(deadline, base * s_q)``.
    """
    if n <= 0 or base_s <= 0:
        return min(base_s, deadline_s) if math.isfinite(deadline_s) else base_s
    q = 0.5 ** (1.0 / max(1, n))
    s = straggler_scale_quantile(q, rate, sigma)
    return min(base_s * s, deadline_s)


def deadline_survivor_frac(base_s: float, rate: float, sigma: float,
                           deadline_s: float) -> float:
    """P(one child's arrival makes the deadline) under the straggler
    mixture — the modeled per-level survivor fraction the fault counters
    measure empirically."""
    if not math.isfinite(deadline_s):
        return 1.0
    if base_s <= 0:
        return 1.0
    r = deadline_s / base_s
    if r < 1.0:
        return 0.0
    p_on_time = 1.0 - rate
    if rate > 0 and sigma > 0 and r > 1.0:
        # P(exp(sigma*|z|) <= r) = 2*Phi(ln r / sigma) - 1
        z = math.log(r) / sigma
        p_on_time += rate * max(0.0, math.erf(z / math.sqrt(2.0)))
    elif rate > 0 and sigma <= 0:
        p_on_time += rate  # degenerate stragglers arrive exactly at base_s
    return min(1.0, p_on_time)


@dataclass(frozen=True)
class CodecProfile:
    """Sustained encode/decode throughput of the payload codec (GB/s).

    Defaults are host-side numpy codec class numbers (sub-GB/s); a fused
    on-device Pallas pack runs far faster and can be profiled in instead.
    """
    pack_gbps: float = 0.75
    unpack_gbps: float = 0.75

    def pack_s(self, nbytes: float) -> float:
        return float(nbytes) / (self.pack_gbps * 1e9)

    def unpack_s(self, nbytes: float) -> float:
        return float(nbytes) / (self.unpack_gbps * 1e9)


DEFAULT_PROFILE = CodecProfile()


def pipelined_time_s(stage_totals_s: Sequence[float], n_tiles: int) -> float:
    """Wall-clock of a tiled pipeline given each stage's *total* time.

    fill: the first tile flows through every stage back to back; steady
    state: the remaining n-1 tiles emerge paced by the slowest stage.  At
    n_tiles=1 this degenerates to the serial sum; as n_tiles grows it
    approaches max(stages).
    """
    n = max(1, int(n_tiles))
    fill = sum(t / n for t in stage_totals_s)
    return fill + max(stage_totals_s) * (n - 1) / n


def stream_pipeline_s(lat_s: float, pack_total_s: float, wire_total_s: float,
                      unpack_total_s: float, n_tiles: int) -> float:
    """Streamed pack | send | unpack pipeline with per-tile wire latency.

    Every tile pays the wire's per-message latency, but tiles overlap in
    flight (the wire is itself a pipeline), so the full per-pass latency
    surfaces exactly once — in the fill, where the first tile traverses the
    wire end to end — while steady state is paced by the slowest
    bandwidth/codec stage.  ``lat_s`` is the latency of ONE tile's complete
    traversal: a point-to-point message pays one hop, a ring collective pays
    its full 2*(g-1) per-step latencies — the same per-message charge the
    serial path pays, never amortized over the tile count.  The result can
    therefore never beat either the bandwidth-only lower bound
    (``wire_total_s``) or the latency floor (``lat_s``).
    """
    return lat_s + pipelined_time_s(
        (pack_total_s, wire_total_s, unpack_total_s), n_tiles)


def ring_parts_s(link: "Link", g: int, nbytes: float) -> tuple:
    """(latency_s, bandwidth_s) decomposition of a ring all-reduce pass."""
    if g <= 1:
        return 0.0, 0.0
    steps = 2 * (g - 1)
    return steps * link.latency_us * 1e-6, (
        2.0 * (g - 1) / g * float(nbytes)) / (link.gbps * 1e9)


def ring_time_s(link: "Link", g: int, nbytes: float) -> float:
    """Ring all-reduce of an nbytes-per-node buffer over g nodes on one link."""
    lat_s, bw_s = ring_parts_s(link, g, nbytes)
    return lat_s + bw_s


@dataclass(frozen=True)
class Link:
    """One link class: sustained bandwidth (GB/s) + per-message latency."""
    gbps: float          # gigabytes per second, per link
    latency_us: float    # one-way message latency, microseconds

    def time_s(self, nbytes: float) -> float:
        return self.latency_us * 1e-6 + float(nbytes) / (self.gbps * 1e9)

    # -- streamed point-to-point message (pack | send | unpack stages) ------
    def serial_codec_time_s(self, nbytes: float,
                            profile: CodecProfile = DEFAULT_PROFILE) -> float:
        """Monolithic path: encode the whole payload, ship it, decode it."""
        return (profile.pack_s(nbytes) + self.time_s(nbytes)
                + profile.unpack_s(nbytes))

    def stream_time_s(self, nbytes: float,
                      tile_bytes: int = DEFAULT_TILE_BYTES,
                      profile: CodecProfile = DEFAULT_PROFILE) -> float:
        """Streamed path: per-tile pack/send/unpack overlap.  Each tile pays
        the per-message latency, overlapped in flight, so one full hop
        latency lands in the fill (see ``stream_pipeline_s``)."""
        n_tiles = max(1, -(-int(nbytes) // int(tile_bytes)))
        return stream_pipeline_s(self.latency_us * 1e-6,
                                 profile.pack_s(nbytes),
                                 float(nbytes) / (self.gbps * 1e9),
                                 profile.unpack_s(nbytes), n_tiles)


@dataclass(frozen=True)
class Topology:
    name: str
    n_pods: int
    devices_per_pod: int
    intra: Link          # cross-device, same pod (ICI-class)
    inter: Link          # cross-pod (DCN / WAN-class)

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.devices_per_pod

    def link(self, kind: str) -> Link:
        if kind == "intra":
            return self.intra
        if kind == "inter":
            return self.inter
        raise KeyError(f"unknown link kind {kind!r} (intra|inter)")

    # -- collective timing (ring model) ------------------------------------
    def allreduce_time_s(self, nbytes: float, scope: str = "intra") -> float:
        """Ring all-reduce of an nbytes-per-device buffer.

        scope: "intra" (one pod, devices_per_pod ring), "inter" (one ring of
        pod leaders over slow links), "global" (hierarchical: intra reduce ->
        inter all-reduce -> intra broadcast, the standard 2-level schedule).
        """
        if scope == "intra":
            return self._ring(self.intra, self.devices_per_pod, nbytes)
        if scope == "inter":
            return self._ring(self.inter, self.n_pods, nbytes)
        if scope == "global":
            return (self._ring_half(self.intra, self.devices_per_pod, nbytes)
                    + self._ring(self.inter, self.n_pods, nbytes)
                    + self._ring_half(self.intra, self.devices_per_pod, nbytes))
        raise KeyError(f"unknown scope {scope!r}")

    # -- streamed collectives (pack | ring | unpack pipeline) ---------------
    def allreduce_serial_time_s(self, nbytes: float, scope: str = "intra",
                                profile: CodecProfile = DEFAULT_PROFILE) -> float:
        """Monolithic compressed all-reduce: every device encodes its full
        contribution, the ring runs, every device decodes — back to back."""
        return (profile.pack_s(nbytes) + self.allreduce_time_s(nbytes, scope)
                + profile.unpack_s(nbytes))

    def allreduce_parts_s(self, nbytes: float, scope: str = "intra") -> tuple:
        """(latency_s, bandwidth_s) decomposition of one all-reduce pass:
        the per-message ring-step latencies vs the bytes/bandwidth term."""
        if scope == "intra":
            return ring_parts_s(self.intra, self.devices_per_pod, nbytes)
        if scope == "inter":
            return ring_parts_s(self.inter, self.n_pods, nbytes)
        if scope == "global":
            hl, hb = self._ring_half_parts(self.intra, self.devices_per_pod,
                                           nbytes)
            il, ib = ring_parts_s(self.inter, self.n_pods, nbytes)
            return 2 * hl + il, 2 * hb + ib
        raise KeyError(f"unknown scope {scope!r}")

    def allreduce_stream_time_s(self, nbytes: float, scope: str = "intra",
                                tile_bytes: int = DEFAULT_TILE_BYTES,
                                profile: CodecProfile = DEFAULT_PROFILE) -> float:
        """Streamed compressed all-reduce: tiles of the encoded buffer enter
        the ring as soon as they are packed, and decode as they land.  The
        per-tile ring pays its full per-step latencies — the same charge the
        serial path pays — surfaced once in the fill (tiles overlap in
        flight); only the bandwidth/codec stages amortize over tiles, so a
        codec-bound pipeline can no longer hide the ring's latency floor."""
        n_tiles = max(1, -(-int(nbytes) // int(tile_bytes)))
        lat_s, bw_s = self.allreduce_parts_s(nbytes, scope)
        return stream_pipeline_s(lat_s, profile.pack_s(nbytes), bw_s,
                                 profile.unpack_s(nbytes), n_tiles)

    @staticmethod
    def _ring(link: Link, g: int, nbytes: float) -> float:
        return ring_time_s(link, g, nbytes)

    @staticmethod
    def _ring_half_parts(link: Link, g: int, nbytes: float) -> tuple:
        if g <= 1:
            return 0.0, 0.0
        steps = g - 1
        return steps * link.latency_us * 1e-6, (
            (g - 1) / g * float(nbytes)) / (link.gbps * 1e9)

    @staticmethod
    def _ring_half(link: Link, g: int, nbytes: float) -> float:
        """Reduce-scatter or all-gather half of the ring."""
        lat_s, bw_s = Topology._ring_half_parts(link, g, nbytes)
        return lat_s + bw_s


# ---------------------------------------------------------------------------
# presets — the scenarios the repo simulates
# ---------------------------------------------------------------------------
PRESETS: Dict[str, Topology] = {
    # 2 TPU pods: ~100 GB/s ICI per chip, ~12.5 GB/s DCN per host link
    "v5p_superpod": Topology("v5p_superpod", n_pods=2, devices_per_pod=256,
                             intra=Link(gbps=100.0, latency_us=1.0),
                             inter=Link(gbps=12.5, latency_us=25.0)),
    # geo-distributed datacenters over WAN
    "geo_wan": Topology("geo_wan", n_pods=4, devices_per_pod=64,
                        intra=Link(gbps=50.0, latency_us=2.0),
                        inter=Link(gbps=1.0, latency_us=20_000.0)),
    # cross-device federated learning: phones behind broadband uplinks
    "edge_fl": Topology("edge_fl", n_pods=100, devices_per_pod=1,
                        intra=Link(gbps=10.0, latency_us=10.0),
                        inter=Link(gbps=0.00625, latency_us=50_000.0)),
}


def get_topology(name: str) -> Topology:
    if name not in PRESETS:
        raise KeyError(f"unknown topology {name!r}; known {sorted(PRESETS)}")
    return PRESETS[name]
