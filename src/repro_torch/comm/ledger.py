"""Byte-accurate communication ledger (the port's copy of
``repro/comm/ledger.py``): one record per message, or per streamed chunk, on
one link, the tag registry, the per-round/link/kind/tag aggregates and the
round-time model over a ``comm.topology.Topology`` preset (a model of that
preset's links, not a time measured on the card).  ``crosscheck_hlo``
compares the ledger's bytes with the collective payloads of a traced step
(``launch.hlo_analysis.CollectiveStats``, the port's counterpart of the
reference's HLO statistics; Queue 1, item 8c).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

RETRY_TAG = "retry"          # retransmissions after a drop / checksum failure
UPLOAD_TAG = "upload"        # leaf -> aggregator payloads
BROADCAST_TAG = "broadcast"  # aggregator -> leaf model pushes
PAGE_IN_TAG = "serve/page_in"    # delta store -> serving block pool (a miss)
PAGE_OUT_TAG = "serve/page_out"  # trainer -> delta store persist (a put)
WIRE_SCHEME_TAGS = frozenset(
    {"dense", "sparse_idx32", "sparse_block", "sparse_bitmap", "quant"})

_RUNTIME_TAGS: set = set()


def register_tag(tag: str) -> str:
    """Register a runtime tag (tree level names etc.); returns it unchanged."""
    _RUNTIME_TAGS.add(str(tag))
    return str(tag)


def known_tags() -> frozenset:
    return (frozenset({RETRY_TAG, UPLOAD_TAG, BROADCAST_TAG,
                       PAGE_IN_TAG, PAGE_OUT_TAG})
            | WIRE_SCHEME_TAGS | frozenset(_RUNTIME_TAGS))


@dataclass(frozen=True)
class CommRecord:
    round: int
    link: str
    kind: str       # "intra" | "inter"
    nbytes: int
    phase: int = 0
    tag: str = ""
    chunk: int = -1


@dataclass
class CommLedger:
    records: List[CommRecord] = field(default_factory=list)

    def record(self, round: int, link: str, nbytes, kind: str = "inter",
               phase: int = 0, tag: str = "", chunk: int = -1) -> CommRecord:
        rec = CommRecord(int(round), link, kind, int(nbytes), int(phase), tag,
                         int(chunk))
        self.records.append(rec)
        return rec

    def record_payload(self, round: int, link: str, payload,
                       kind: str = "inter", phase: int = 0,
                       tag: str = "") -> CommRecord:
        return self.record(round, link, payload.nbytes, kind=kind, phase=phase,
                           tag=tag or payload.scheme)

    def record_stream(self, round: int, link: str, stream, kind: str = "inter",
                      phase: int = 0, tag: str = "") -> List[CommRecord]:
        """One record per chunk of a ``codecs.StreamPayload``; the chunk
        records sum exactly to the whole payload's ``nbytes``."""
        base = tag or stream.scheme
        return [self.record(round, link, ch.nbytes, kind=kind, phase=phase,
                            tag=base, chunk=ch.index)
                for ch in stream.chunks]

    def merge(self, other: "CommLedger") -> "CommLedger":
        self.records.extend(other.records)
        return self

    @classmethod
    def from_rounds(cls, nbytes, n_rounds: int, link: str = "client->server",
                    kind: str = "inter", phase: int = 0) -> "CommLedger":
        """One constant-size message per round: the ledger of a
        fixed-payload run (size-invariant compressors)."""
        led = cls()
        for t in range(n_rounds):
            led.record(t, link, nbytes, kind=kind, phase=phase)
        return led

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.records)

    @property
    def total_bits(self) -> int:
        return 8 * self.total_bytes

    def n_rounds(self) -> int:
        return (max(r.round for r in self.records) + 1) if self.records else 0

    def cumulative_bytes(self) -> List[int]:
        """Running total after each round 0..n_rounds-1 (Fig 2.2 x-axis)."""
        per, acc, out = self.bytes_by_round(), 0, []
        for t in range(self.n_rounds()):
            acc += per.get(t, 0)
            out.append(acc)
        return out

    def _by(self, attr: str) -> Dict:
        out: Dict = defaultdict(int)
        for r in self.records:
            out[getattr(r, attr)] += r.nbytes
        return dict(out)

    def bytes_by_round(self) -> Dict[int, int]:
        return self._by("round")

    def bytes_by_link(self) -> Dict[str, int]:
        return self._by("link")

    def bytes_by_kind(self) -> Dict[str, int]:
        return self._by("kind")

    def bytes_by_tag(self) -> Dict[str, int]:
        return self._by("tag")

    @property
    def retry_bytes(self) -> int:
        """Bytes charged to retransmissions (faulty links re-sending after a
        drop or a checksum-caught corruption, tag :data:`RETRY_TAG`)."""
        return sum(r.nbytes for r in self.records if r.tag == RETRY_TAG)

    def bits_per_node(self, n_nodes: int) -> float:
        """Total bits divided by participating nodes — the paper's metric."""
        return self.total_bits / max(1, n_nodes)

    # -- simulation (a model of the topology preset) -------------------------
    def round_time_s(self, topo, round: int) -> float:
        """Modelled wall-clock of one round on ``topo``: links within a phase
        run in parallel (each link serializes its own messages), phases run
        back to back."""
        by_phase: Dict[int, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        for r in self.records:
            if r.round != round:
                continue
            by_phase[r.phase][r.link] += topo.link(r.kind).time_s(r.nbytes)
        return sum(max(links.values()) for links in by_phase.values()) if by_phase else 0.0

    def total_time_s(self, topo) -> float:
        return sum(self.round_time_s(topo, t) for t in range(self.n_rounds()))

    def summary(self) -> str:
        kinds = ";".join(f"{k}={v}" for k, v in sorted(self.bytes_by_kind().items()))
        return (f"rounds={self.n_rounds()} msgs={len(self.records)} "
                f"bytes={self.total_bytes} ({kinds})")


# ---------------------------------------------------------------------------
# Cross-check against a traced step's collectives
# ---------------------------------------------------------------------------
def crosscheck_hlo(ledger: CommLedger, stats, rel_tol: float = 0.25) -> dict:
    """Compare ledger totals with ``launch.hlo_analysis.CollectiveStats``
    (the reference's keys).  The stats count the per-rank collective
    payload of one traced step; the ledger counts encoded message bytes.
    They agree when the step's collectives carry the encoded planes and
    diverge when compression is only modeled: the ratio is the audit
    number."""
    hlo_total = float(stats.total_bytes)
    led_total = float(ledger.total_bytes)
    ratio = led_total / hlo_total if hlo_total > 0 else float("inf")
    return {
        "ledger_bytes": led_total,
        "hlo_bytes": hlo_total,
        "hlo_inter_pod_bytes": float(stats.inter_pod_bytes),
        "ratio": ratio,
        "consistent": hlo_total > 0 and abs(ratio - 1.0) <= rel_tol,
    }
