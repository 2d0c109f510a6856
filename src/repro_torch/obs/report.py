"""Measured-vs-modeled round reports: join a trace with the RoundCost model
(port of ``repro/obs/report.py``).

A traced run (``REPRO_TRACE=1``, or ``chip_smoke.py``'s traced round)
leaves two artifacts:

* a trace JSONL (``repro_torch.obs.trace.export_jsonl``, the JAX package's
  format) whose spans carry the
  measured wall-time of each round phase — pack -> encode -> allreduce ->
  decode -> adopt — with per-payload ``nbytes``/``level`` tags, and a meta
  header recording the sync config and round count;
* optionally a metrics JSON (``MetricsRegistry.export_json``) carrying the
  ``CommLedger`` per-level byte attribution.

This module joins them with ``repro_torch.comm.round_cost``'s *model* of the same
round: per phase, measured wall-time next to the ``serial_time_s`` /
``pipelined_time_s`` prediction with a ``model_error%`` column, and a
per-level audit that the bytes the trace saw match the ledger exactly.
Ledger tags with no trace counterpart (``retry``: a re-sent payload is one
encode but several wire messages) are displayed but excluded from the match
verdict.  When the metrics JSON carries ``faults/*`` series (fault-injected
runs), a degraded-rounds section reports drops, retries, deadline misses and
the per-level survivor fraction.

The modelled times are the reference's link model on a topology preset
(default ``v5p_superpod``): a model of that cluster, not a measurement of
the card the trace was taken on.  Sizing the modelled round encodes a probe
payload (``round_cost``) on ``device``: the card unless the caller passes
another (``--device cpu``).

CLI::

    python -m repro_torch.obs.report TRACE.jsonl [--metrics METRICS.json]
        [--params N] [--rounds R] [--mode hier] [--compressor qsgd]
        [--device cpu] ...

Exit status is non-zero if a ledger was provided and the per-level measured
bytes do not match it.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import Span, load_jsonl

PHASES = ("pack", "encode", "allreduce", "decode", "adopt")

# ledger tags that have no encode-span counterpart in the trace: shown in the
# byte audit but exempt from the exact-match requirement (serve/page_in is a
# decode-side transfer; serve/page_out is a store write, not an upload)
UNTRACED_TAGS = frozenset({"retry", "serve/page_in", "serve/page_out"})

# serving-path spans (training.serving.ContinuousBatcher instrumentation)
_SERVE_SPANS = ("serve/admit", "serve/prefill", "serve/decode")

# span-name prefixes -> canonical round phase
_PHASE_PREFIXES = (
    ("sync/pack", "pack"),
    ("sync/bucketize", "pack"),
    ("codec/encode", "encode"),
    ("kernel/quantize_pack", "encode"),
    ("kernel/stream_quant_pack", "encode"),
    ("sync/allreduce", "allreduce"),
    ("comm/allreduce", "allreduce"),
    ("comm/send", "allreduce"),
    ("codec/decode", "decode"),
    ("sync/adopt", "adopt"),
    ("sync/debucketize", "adopt"),
)


def phase_of(name: str) -> Optional[str]:
    for prefix, phase in _PHASE_PREFIXES:
        if name.startswith(prefix):
            return phase
    return None


def _outermost(spans: List[Span]) -> List[Span]:
    """Drop spans enclosed by another span of the same phase (a chunked
    encode records per-chunk child spans inside the whole-payload span; only
    the outermost one counts toward the phase total)."""
    out = []
    for i, s in enumerate(spans):
        ph = phase_of(s.name)
        enclosed = any(
            j != i and phase_of(o.name) == ph and o.encloses(s)
            and (o.dur_us, o.ts_us) != (s.dur_us, s.ts_us)
            for j, o in enumerate(spans))
        if not enclosed:
            out.append(s)
    return out


def measured_phase_seconds(spans: List[Span]) -> Dict[str, float]:
    """Total measured wall-time per canonical phase (outermost spans only)."""
    phase_spans = [s for s in spans if phase_of(s.name)]
    totals = {p: 0.0 for p in PHASES}
    for s in _outermost(phase_spans):
        totals[phase_of(s.name)] += s.dur_us / 1e6
    return totals


def measured_bytes_by_level(spans: List[Span]) -> Dict[str, float]:
    """Sum of encode-span ``nbytes`` tags, grouped by their ``level`` tag
    (ambient-tagged by the sync path) — the trace's measured wire bytes."""
    enc = [s for s in spans
           if phase_of(s.name) == "encode" and "nbytes" in s.tags
           and "chunk" not in s.name]  # chunk spans re-count payload bytes
    out: Dict[str, float] = {}
    for s in _outermost(enc):
        level = str(s.tags.get("level", s.tags.get("tag", "payload")))
        out[level] = out.get(level, 0.0) + float(s.tags["nbytes"])
    return out


# ---------------------------------------------------------------------------
# the model side
# ---------------------------------------------------------------------------
def sync_from_meta(meta: dict):
    """Rebuild the SyncConfig a traced run recorded in its meta header."""
    from repro_torch.configs.base import LevelConfig, SyncConfig

    s = dict(meta.get("sync") or {})
    if not s:
        return None
    levels = tuple(LevelConfig(**lc) for lc in s.pop("levels", ()) or ())
    return SyncConfig(levels=levels if levels else None, **s)


def modeled_phase_seconds(sync, n_params: int,
                          topology=None, device=None) -> Tuple[Dict[str, Optional[float]],
                                                  Dict[str, float]]:
    """Per-round (amortized) modeled seconds per phase, plus the per-level
    modeled bytes — decomposed from the same ``round_cost`` the rest of the
    repo reports, so the report's model column can never drift from it.

    pack/adopt (host staging, bucketize/debucketize) are not modeled:
    their entries are None and excluded from the error column.
    """
    from repro_torch.comm import DEFAULT_PROFILE, round_cost
    from repro_torch.comm.topology import get_topology

    if isinstance(topology, str):
        topology = get_topology(topology)
    cost = round_cost(sync, n_params, topology=topology, device=device)
    prof = DEFAULT_PROFILE
    phases: Dict[str, Optional[float]] = {"pack": None, "encode": 0.0,
                                          "allreduce": 0.0, "decode": 0.0,
                                          "adopt": None}
    level_bytes: Dict[str, float] = {}
    if cost.levels:
        for lv in cost.levels:
            full_bytes = lv.bytes_per_round * lv.period
            level_bytes[lv.name] = lv.bytes_per_round
            if lv.compressor == "identity":
                pack_s = unpack_s = 0.0
            else:
                pack_s = prof.pack_s(full_bytes)
                unpack_s = prof.unpack_s(full_bytes)
            ring_s = max(0.0, lv.serial_time_s * lv.period - pack_s - unpack_s)
            phases["encode"] += pack_s / lv.period
            phases["allreduce"] += ring_s / lv.period
            phases["decode"] += unpack_s / lv.period
    else:
        period = max(1, getattr(sync, "sync_period", 1))
        amort = period if sync.mode == "local" else 1
        full_bytes = cost.inter_bytes * amort
        level_bytes["payload"] = cost.inter_bytes
        if sync.mode in ("dense", "local"):
            pack_s = unpack_s = 0.0
        else:
            pack_s = prof.pack_s(full_bytes)
            unpack_s = prof.unpack_s(full_bytes)
        ring_s = max(0.0, cost.serial_time_s * amort - pack_s - unpack_s)
        phases["encode"] = pack_s / amort
        phases["allreduce"] = ring_s / amort
        phases["decode"] = unpack_s / amort
    return phases, level_bytes


def _serve_stats_from_metrics(mdoc: dict) -> Dict[str, float]:
    """``serve/*`` totals from a metrics JSON — either the ``serve_stats``
    extra a bench exports, or the raw metric entries from a traced run."""
    ss = mdoc.get("serve_stats")
    if ss:
        return {str(k): float(v) for k, v in ss.items()}
    out: Dict[str, float] = {}
    for m in mdoc.get("metrics", []):
        name = str(m.get("name", ""))
        if name.startswith("serve/"):
            out[name[len("serve/"):]] = float(
                m.get("total", m.get("value", 0.0)) or 0.0)
    return out


def _serve_span_table(spans: List[Span]) -> Dict[str, Tuple[int, float]]:
    """(count, total seconds) per serving span name."""
    out: Dict[str, Tuple[int, float]] = {}
    for s in spans:
        if s.name in _SERVE_SPANS:
            n, tot = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, tot + s.dur_us / 1e6)
    return out


def _fault_stats_from_metrics(mdoc: dict) -> Dict[str, float]:
    """``faults/*`` totals from a metrics JSON — either the ``fault_stats``
    extra a bench exports, or the raw metric entries from a traced run."""
    fs = mdoc.get("fault_stats")
    if fs:
        return {str(k): float(v) for k, v in fs.items()}
    out: Dict[str, float] = {}
    for m in mdoc.get("metrics", []):
        name = str(m.get("name", ""))
        if name.startswith("faults/"):
            out[name[len("faults/"):]] = float(
                m.get("total", m.get("value", 0.0)) or 0.0)
    return out


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------
def _fmt_ms(s: Optional[float]) -> str:
    return f"{s * 1e3:10.3f}" if s is not None else f"{'—':>10}"


def _fmt_err(measured: float, modeled: Optional[float]) -> str:
    if modeled is None or modeled <= 0.0:
        return f"{'—':>12}"
    return f"{(measured - modeled) / modeled * 100.0:+11.1f}%"


def build_report(trace_path: str, metrics_path: Optional[str] = None,
                 sync=None, n_params: Optional[int] = None,
                 n_rounds: Optional[int] = None,
                 device=None) -> Tuple[str, dict]:
    """Render the measured-vs-modeled round report.

    Returns (text, result dict); ``result["bytes_match"]`` is None when no
    ledger was supplied, else the per-level exact-match verdict.
    """
    meta, spans = load_jsonl(trace_path)
    sync = sync or sync_from_meta(meta)
    n_params = n_params or meta.get("n_params")
    n_rounds = n_rounds or int(meta.get("n_rounds", 1) or 1)

    measured = measured_phase_seconds(spans)
    measured_total = sum(measured.values())
    trace_bytes = measured_bytes_by_level(spans)

    modeled: Dict[str, Optional[float]] = {p: None for p in PHASES}
    serial_s = pipelined_s = None
    if sync is not None and n_params:
        from repro_torch.comm import round_cost

        modeled, _ = modeled_phase_seconds(sync, int(n_params), device=device)
        modeled = {p: (v * n_rounds if v is not None else None)
                   for p, v in modeled.items()}
        cost = round_cost(sync, int(n_params), device=device)
        serial_s = cost.serial_time_s * n_rounds
        pipelined_s = cost.time_s * n_rounds

    ledger_bytes: Optional[Dict[str, float]] = None
    fault_stats: Dict[str, float] = {}
    serve_stats: Dict[str, float] = {}
    if metrics_path:
        with open(metrics_path) as f:
            mdoc = json.load(f)
        lb = mdoc.get("ledger_bytes_by_tag")
        if lb:
            ledger_bytes = {str(k): float(v) for k, v in lb.items()}
        fault_stats = _fault_stats_from_metrics(mdoc)
        serve_stats = _serve_stats_from_metrics(mdoc)
    serve_spans = _serve_span_table(spans)

    lines = []
    title = meta.get("label") or trace_path
    lines.append(f"round report — {title}")
    if sync is not None:
        desc = f"mode={sync.mode} compressor={sync.compressor}"
        if getattr(sync, "levels", None):
            desc += " levels=" + ",".join(
                f"{lc.name}:{lc.compressor}/p{lc.period}" for lc in sync.levels)
        lines.append(f"  {desc} n_params={n_params} rounds={n_rounds} "
                     f"topology={getattr(sync, 'topology', '?')}")
    lines.append(f"  spans={len(spans)} evicted={meta.get('n_evicted', 0)}")
    lines.append("")
    lines.append(f"  {'phase':<10} {'measured_ms':>10} {'modeled_ms':>10} "
                 f"{'model_error%':>12}")
    for p in PHASES:
        lines.append(f"  {p:<10} {_fmt_ms(measured[p])} {_fmt_ms(modeled[p])} "
                     f"{_fmt_err(measured[p], modeled[p])}")
    modeled_total = sum(v for v in modeled.values() if v is not None)
    lines.append(f"  {'total':<10} {_fmt_ms(measured_total)} "
                 f"{_fmt_ms(modeled_total if serial_s is not None else None)} "
                 f"{_fmt_err(measured_total, modeled_total if serial_s is not None else None)}")
    if serial_s is not None:
        lines.append(f"  model serial={serial_s * 1e3:.3f} ms  "
                     f"pipelined={pipelined_s * 1e3:.3f} ms  "
                     f"(stream speedup {serial_s / pipelined_s:.2f}x)"
                     if pipelined_s else "")

    bytes_match: Optional[bool] = None
    if trace_bytes or ledger_bytes:
        lines.append("")
        lines.append(f"  {'level':<10} {'trace_bytes':>12} {'ledger_bytes':>12} "
                     f"{'match':>6}")
        levels = sorted(set(trace_bytes) | set(ledger_bytes or {}))
        if ledger_bytes is not None:
            bytes_match = True
        for lvl in levels:
            tb = trace_bytes.get(lvl)
            lb = (ledger_bytes or {}).get(lvl)
            if lvl in UNTRACED_TAGS:
                lines.append(
                    f"  {lvl:<10} "
                    f"{int(tb) if tb is not None else '—':>12} "
                    f"{int(lb) if lb is not None else '—':>12} "
                    f"{'—':>6}")
                continue
            ok = (tb is not None and lb is not None
                  and int(round(tb)) == int(round(lb)))
            if ledger_bytes is not None and not ok:
                bytes_match = False
            lines.append(
                f"  {lvl:<10} "
                f"{int(tb) if tb is not None else '—':>12} "
                f"{int(lb) if lb is not None else '—':>12} "
                f"{(str(ok) if ledger_bytes is not None else '—'):>6}")
        if bytes_match is not None:
            lines.append(f"  per-level measured bytes match CommLedger: "
                         f"{bytes_match}")

    if fault_stats:
        lines.append("")
        lines.append("  degraded rounds (fault injection):")
        counters = [(k, fault_stats[k]) for k in
                    ("drops", "retries", "deadline_misses", "corrupt",
                     "unavailable") if k in fault_stats]
        if counters:
            lines.append("    " + "  ".join(f"{k}={int(round(v))}"
                                            for k, v in counters))
        fracs = {k[len("survivor_frac/"):]: v for k, v in fault_stats.items()
                 if k.startswith("survivor_frac/")}
        if fracs:
            lines.append("    survivor_frac  " + "  ".join(
                f"{lvl}={v:.3f}" for lvl, v in sorted(fracs.items())))
        if "round_time_s" in fault_stats:
            lines.append(f"    degraded round_time="
                         f"{fault_stats['round_time_s'] * 1e3:.3f} ms")

    if serve_spans or serve_stats:
        lines.append("")
        lines.append("  serving path (continuous batcher):")
        for name in _SERVE_SPANS:
            if name in serve_spans:
                n, tot = serve_spans[name]
                lines.append(f"    {name:<14} n={n:<5} "
                             f"total={tot * 1e3:.3f} ms")
        sched = [(k, serve_stats[k]) for k in
                 ("admitted", "completed", "prefills", "decode_steps",
                  "tokens_out") if k in serve_stats]
        if sched:
            lines.append("    " + "  ".join(f"{k}={int(round(v))}"
                                            for k, v in sched))
        pool = {k[len("pool/"):]: v for k, v in serve_stats.items()
                if k.startswith("pool/")}
        if pool:
            lines.append("    pool  " + "  ".join(
                f"{k}={int(round(v))}" for k, v in sorted(pool.items())))
        graph = {k[len("graph/"):]: v for k, v in serve_stats.items()
                 if k.startswith("graph/")}
        if graph:
            lines.append("    graph  " + "  ".join(
                f"{k}={int(round(v))}" for k, v in sorted(graph.items())))

    result = {
        "measured_s": measured, "modeled_s": modeled,
        "measured_total_s": measured_total,
        "serial_model_s": serial_s, "pipelined_model_s": pipelined_s,
        "trace_bytes": trace_bytes, "ledger_bytes": ledger_bytes,
        "bytes_match": bytes_match, "n_spans": len(spans),
        "fault_stats": fault_stats or None,
        "serve_stats": serve_stats or None,
        "serve_spans": {k: {"n": n, "total_s": t}
                        for k, (n, t) in serve_spans.items()} or None,
    }
    return "\n".join(lines) + "\n", result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Measured-vs-modeled round report from a trace JSONL.")
    ap.add_argument("trace", help="trace JSONL from repro_torch.obs.trace.export_jsonl")
    ap.add_argument("--metrics", default=None,
                    help="metrics JSON with ledger_bytes_by_tag (audit)")
    ap.add_argument("--params", type=int, default=None,
                    help="model dimension (defaults to the trace meta)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds the trace covers (defaults to meta)")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--compressor", default=None)
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--compress-ratio", type=float, default=0.05)
    ap.add_argument("--sync-period", type=int, default=1)
    ap.add_argument("--topology", default="v5p_superpod")
    ap.add_argument("--json", default=None,
                    help="also dump the joined report dict to this path")
    ap.add_argument("--device", default=None,
                    help="torch device of the model's probe encode; default: "
                         "the CUDA card")
    args = ap.parse_args(argv)

    sync = None
    if args.mode:
        from repro_torch.configs.base import SyncConfig

        sync = SyncConfig(mode=args.mode, compressor=args.compressor or "qsgd",
                          quant_bits=args.quant_bits,
                          compress_ratio=args.compress_ratio,
                          sync_period=args.sync_period,
                          topology=args.topology)
    text, result = build_report(args.trace, metrics_path=args.metrics,
                                sync=sync, n_params=args.params,
                                n_rounds=args.rounds, device=args.device)
    sys.stdout.write(text)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1, default=str)
            f.write("\n")
    return 1 if result["bytes_match"] is False else 0


if __name__ == "__main__":
    sys.exit(main())
