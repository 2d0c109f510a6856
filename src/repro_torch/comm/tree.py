"""Aggregation trees: arbitrary-depth link hierarchies (Cohort-Squeeze, Ch. 5).

(The port's copy of ``repro/comm/tree.py``; its times, like
``topology.py``'s, model the named preset, not the card.)

The flat ``Topology`` hard-codes one intra/inter split, but the deployments
the dissertation measures have *more than two* link classes — device -> host
-> region -> cloud — and hierarchical aggregation wins precisely because each
extra hop lets a slower link carry a more aggressively compressed, less
frequent payload.  A ``TreeTopology`` is an ordered list of ``TreeLevel``s,
leaf-most first: level ``l`` groups ``fanout`` child nodes under one parent
and times their aggregation ring on that level's ``Link`` (with an optional
per-level ``CodecProfile`` for the compressed levels).  Today's two-level
``Topology`` is exactly the depth-2 special case (``TreeTopology.from_flat``).

Node counting: ``n_leaves = prod(fanout_l)``; level ``l`` has
``n_leaves / prod(fanout_0..l)`` parent nodes, and the last level's single
parent is the root.  The collective model per level is the same ring used by
``Topology`` (``ring_parts_s``), so a depth-2 tree reproduces the flat
preset's numbers bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from repro_torch.comm.topology import (DEFAULT_PROFILE, DEFAULT_TILE_BYTES,
                                 CodecProfile, Link, Topology, get_topology,
                                 ring_parts_s, ring_time_s,
                                 straggler_level_time_s, stream_pipeline_s)
from repro_torch.faults.model import FaultConfig, LinkFaults


@dataclass(frozen=True)
class TreeLevel:
    """One aggregation hop: ``fanout`` children reach their parent over
    ``link``; compressed payloads at this level pay ``profile`` codec time.
    ``faults`` (optional) attaches this link class's per-message fault rates
    — a preset-level default a ``FaultConfig`` can still override by name."""
    name: str
    fanout: int
    link: Link
    profile: CodecProfile = DEFAULT_PROFILE
    faults: Optional[LinkFaults] = None


@dataclass(frozen=True)
class TreeTopology:
    """Named levels leaf-most first; ``levels[-1]`` reaches the root."""
    name: str
    levels: Tuple[TreeLevel, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("TreeTopology needs at least one level")
        from repro_torch.comm.ledger import register_tag
        for lev in self.levels:
            if lev.fanout < 1:
                raise ValueError(f"level {lev.name!r}: fanout must be >= 1")
            # ledger records are tagged with the level name; register it so
            # bytes_by_tag() attribution stays within the known-tag namespace
            register_tag(lev.name)

    # -- shape ---------------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_leaves(self) -> int:
        n = 1
        for lev in self.levels:
            n *= lev.fanout
        return n

    def n_parents(self, l: int) -> int:
        """Number of aggregator nodes at level ``l`` (1 at the root)."""
        n = self.n_leaves
        for lev in self.levels[: l + 1]:
            n //= lev.fanout
        return n

    def n_children(self, l: int) -> int:
        """Number of child nodes feeding level ``l`` (leaves for l=0)."""
        n = self.n_leaves
        for lev in self.levels[:l]:
            n //= lev.fanout
        return n

    def level_faults(self, l: int, cfg: Optional[FaultConfig]) -> LinkFaults:
        """Effective fault rates at level ``l``: the ``FaultConfig``'s
        per-level override wins, then the level's attached default, then the
        config's global rates (all-zero without a config)."""
        lev = self.levels[l]
        if cfg is not None and (cfg.has_override(lev.name)
                                or lev.faults is None):
            return cfg.link_faults(lev.name)
        if lev.faults is not None:
            return lev.faults
        return LinkFaults()

    def level_index(self, name: str) -> int:
        for i, lev in enumerate(self.levels):
            if lev.name == name:
                return i
        raise KeyError(f"unknown level {name!r}; known "
                       f"{[lev.name for lev in self.levels]}")

    def level(self, name: str) -> TreeLevel:
        return self.levels[self.level_index(name)]

    # -- timing (per-level ring model) ---------------------------------------
    def ring_parts_s(self, l: int, nbytes: float) -> tuple:
        lev = self.levels[l]
        return ring_parts_s(lev.link, lev.fanout, nbytes)

    def ring_time_s(self, l: int, nbytes: float) -> float:
        lev = self.levels[l]
        return ring_time_s(lev.link, lev.fanout, nbytes)

    def level_serial_time_s(self, l: int, nbytes: float, codec: bool = True,
                            profile: CodecProfile = None) -> float:
        """Monolithic pass at level ``l``: pack -> ring -> unpack (``codec=
        False`` for dense fp32 levels, which ship without a codec;
        ``profile`` overrides the level's own codec profile)."""
        prof = profile or self.levels[l].profile
        t = self.ring_time_s(l, nbytes)
        if not codec:
            return t
        return prof.pack_s(nbytes) + t + prof.unpack_s(nbytes)

    def level_stream_time_s(self, l: int, nbytes: float,
                            tile_bytes: int = DEFAULT_TILE_BYTES,
                            profile: CodecProfile = None) -> float:
        """Streamed pass at level ``l`` (per-tile latency model — see
        ``stream_pipeline_s``)."""
        prof = profile or self.levels[l].profile
        n_tiles = max(1, -(-int(nbytes) // int(tile_bytes)))
        lat_s, bw_s = self.ring_parts_s(l, nbytes)
        return stream_pipeline_s(lat_s, prof.pack_s(nbytes), bw_s,
                                 prof.unpack_s(nbytes), n_tiles)

    def level_degraded_time_s(self, l: int, nbytes: float,
                              cfg: FaultConfig, codec: bool = True,
                              profile: CodecProfile = None) -> float:
        """Modeled completion time of level ``l`` under faults.

        The level finishes at the order statistic of the straggler max over
        its children, capped by the per-level deadline — NOT the mean child
        time (one straggler in 25 children moves the max far more than the
        average).  Lost attempts inflate the base time by the expected
        transmission count plus the expected first backoff.
        """
        lev = self.levels[l]
        base = self.level_serial_time_s(l, nbytes, codec=codec,
                                        profile=profile)
        lf = self.level_faults(l, cfg)
        e_tx = cfg.expected_transmissions(lf.loss_rate)
        base = base * e_tx + cfg.backoff_s * (e_tx - 1.0)
        if lf.delay_rate > 0:
            base += lf.delay_rate * lf.delay_s
        return straggler_level_time_s(base, cfg.straggler_rate,
                                      cfg.straggler_sigma,
                                      self.n_children(l),
                                      cfg.level_deadline_s(lev.name))

    def with_n_leaves(self, n: int) -> "TreeTopology":
        """Same hierarchy rescaled so ``n_leaves == n`` by widening the leaf
        fanout (upper fanouts unchanged).

        The infrastructure above the leaf hop — cells, regions, the root —
        persists while cohorts of any size occupy the leaf slots, which is
        exactly the cross-device picture: ``edge_fl_tree.with_n_leaves(10**5)``
        keeps 5 metro aggregators per region and 4 regions, but each cell now
        fronts 5000 phones.  ``n`` must be a multiple of the upper fanouts'
        product.
        """
        upper = 1
        for lev in self.levels[1:]:
            upper *= lev.fanout
        if n < upper or n % upper != 0:
            raise ValueError(
                f"cannot rescale {self.name!r} to {n} leaves: upper-level "
                f"fanouts multiply to {upper}, need a positive multiple")
        leaf = replace(self.levels[0], fanout=n // upper)
        return TreeTopology(f"{self.name}/leaves{n}",
                            (leaf,) + self.levels[1:])

    # -- depth-2 bridge ------------------------------------------------------
    @classmethod
    def from_flat(cls, topo: Topology) -> "TreeTopology":
        """Lift a flat intra/inter ``Topology`` to its depth-2 tree."""
        return cls(topo.name, (
            TreeLevel("intra", topo.devices_per_pod, topo.intra),
            TreeLevel("inter", topo.n_pods, topo.inter),
        ))


# ---------------------------------------------------------------------------
# presets — multi-level variants of the flat scenarios
# ---------------------------------------------------------------------------
TREE_PRESETS: Dict[str, TreeTopology] = {
    # chip -> host -> pod -> cross-pod: ICI, host interconnect, DCN
    "v5p_superpod_tree": TreeTopology("v5p_superpod_tree", (
        TreeLevel("ici", 16, Link(gbps=100.0, latency_us=1.0)),
        TreeLevel("host", 16, Link(gbps=45.0, latency_us=5.0)),
        TreeLevel("dcn", 2, Link(gbps=12.5, latency_us=25.0)),
    )),
    # device -> host -> datacenter -> region over WAN
    "geo_wan_tree": TreeTopology("geo_wan_tree", (
        TreeLevel("ici", 8, Link(gbps=50.0, latency_us=2.0)),
        TreeLevel("dcn", 8, Link(gbps=12.5, latency_us=25.0)),
        TreeLevel("wan", 4, Link(gbps=1.0, latency_us=20_000.0)),
    )),
    # phone -> cell-edge -> region -> cloud: the cross-device hierarchy of
    # Ch. 5 (broadband uplink, metro fiber, inter-region WAN); 100 phones
    # total, matching the flat edge_fl preset's 100 single-device pods
    "edge_fl_tree": TreeTopology("edge_fl_tree", (
        TreeLevel("uplink", 5, Link(gbps=0.00625, latency_us=50_000.0)),
        TreeLevel("metro", 5, Link(gbps=1.0, latency_us=2_000.0)),
        TreeLevel("wan", 4, Link(gbps=1.0, latency_us=20_000.0)),
    )),
}


def get_tree_topology(name: str) -> TreeTopology:
    """Tree preset by name; flat preset names resolve to their depth-2 lift."""
    if name in TREE_PRESETS:
        return TREE_PRESETS[name]
    return TreeTopology.from_flat(get_topology(name))


def register_tree_topology(tree: TreeTopology) -> TreeTopology:
    """Register a custom tree (benchmark depth sweeps, tests)."""
    TREE_PRESETS[tree.name] = tree
    return tree
