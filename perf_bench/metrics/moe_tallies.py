"""The program's expert-layer tallies of the traced window (the spans'
window: the program's trace is reset when it opens), read once into a
metrics registry: ``moe/held_rows`` (assignments the held experts
computed) and ``moe/tokens`` (the tokens of those calls)."""
from perf_bench.harness import bench


def read(run):
    """(the configuration's family module, held rows, tokens) or None where
    the program keeps no such tally (or the family counts no expert
    layer)."""
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import MetricsRegistry

    tracer = trace.get_tracer()
    fam = bench.load_py("families", run.config["family"])
    if not hasattr(tracer, "tallies") or not hasattr(fam, "moe_flops"):
        return None
    reg = MetricsRegistry()
    reg.ingest_tallies(tracer)
    rows, tokens = reg.get("moe/held_rows"), reg.get("moe/tokens")
    if rows is None or tokens is None or not tokens.total:
        return None
    return fam, rows.total, tokens.total
