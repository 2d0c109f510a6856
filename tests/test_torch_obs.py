"""The port's observability layer against the JAX package's: the flight
recorder (``repro_torch.obs.trace``: nesting, ``traced`` / ``ambient``
tags, the ring buffer, the disabled no-op, the exporters), trace JSONL
crossing between the two packages both ways, ``build_report`` of both
packages on the same files, a port-traced hier round audited against its
ledger (``chip_smoke.traced_round`` on the CPU), ``utils.logging``'s
strings, and the training loop's ``round`` line and profiler ranges.

Equalities are exact (spans, byte tallies, strings, report text); report
times, read from the same trace, are equal floats and the modelled ones,
from the two packages' ``round_cost``, agree within rtol 1e-12.
About 12 s alone on 2 threads.
"""
import ast
import json
import logging
import os
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as treport
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import logging as tlogging

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _reset_obs():
    obs_trace.enable(capacity=obs_trace.DEFAULT_CAPACITY, profiler_annotations=False)
    obs_trace.disable()
    obs_trace.get_tracer().reset()
    obs_metrics.registry.reset()


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts and ends with tracing off and empty global state."""
    _reset_obs()
    yield
    _reset_obs()


def _reset_ref_trace(trace):
    """The JAX package's flight recorder as ``_reset_obs`` leaves the port's:
    default capacity, off, no spans, no meta.  Its own tests may leave spans
    behind in this worker's process."""
    trace.enable(capacity=trace.DEFAULT_CAPACITY)
    trace.disable()
    trace.get_tracer().reset()
    trace.get_tracer().meta.clear()


@pytest.fixture
def ref_trace():
    from repro.obs import trace
    _reset_ref_trace(trace)
    yield trace
    _reset_ref_trace(trace)


def test_ref_trace_reset_clears_a_stale_recorder():
    """A span and meta left in the JAX package's recorder (as one of its own
    tests leaves them) are gone after the fixture's reset."""
    from repro.obs import trace
    trace.enable(capacity=8)
    with trace.span("codec/encode", nbytes=100, level="uplink"):
        pass
    trace.set_meta(label="stale")
    assert trace.get_tracer().spans() and trace.get_tracer().meta
    _reset_ref_trace(trace)
    tr = trace.get_tracer()
    assert not trace.enabled() and tr.capacity == trace.DEFAULT_CAPACITY
    assert tr.spans() == [] and tr.meta == {}


def test_public_names_match_the_reference():
    from repro import obs as jobs
    from repro.obs import trace as jtrace
    import repro_torch.obs as tobs
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    public = {n for n in vars(jtrace) if not n.startswith("_") and n not in (
        "annotations", "json", "os", "threading", "time", "dataclass", "field",
        "Dict", "List", "Optional", "Tuple")}
    assert public <= set(vars(obs_trace)), public - set(vars(obs_trace))


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
def test_span_nesting_depth_and_tid():
    obs_trace.enable()
    with obs_trace.span("outer", level="inter") as outer:
        with obs_trace.span("inner") as inner:
            time.sleep(0.001)
            inner.tag(nbytes=42)
        outer.tag(ok=True)
    inner, outer = obs_trace.get_tracer().spans()           # close order
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.depth == 1 and outer.depth == 0
    assert inner.tid == outer.tid and outer.encloses(inner) and not inner.encloses(outer)
    assert inner.tags == {"nbytes": 42} and outer.tags == {"level": "inter", "ok": True}
    assert inner.dur_us > 0 and outer.dur_us >= inner.dur_us


def test_traced_decorator_and_ambient_tags():
    obs_trace.enable()

    @obs_trace.traced("work/fn", kind="unit")
    def fn(x):
        return x + 1

    with obs_trace.ambient(level="dcn"):
        with obs_trace.ambient(pod=3):
            assert fn(1) == 2
        assert fn(2) == 3
    a, b = obs_trace.get_tracer().spans()
    assert a.name == b.name == "work/fn"
    assert a.tags == {"kind": "unit", "level": "dcn", "pod": 3}
    assert b.tags == {"kind": "unit", "level": "dcn"}
    assert fn.__wrapped__(0) == 1 and fn.__name__ == "fn"


def test_ring_buffer_eviction():
    obs_trace.enable(capacity=8)
    for i in range(20):
        with obs_trace.span(f"s{i}"):
            pass
    tr = obs_trace.get_tracer()
    assert tr.capacity == 8 and tr.n_recorded == 20 and tr.n_evicted == 12
    assert [s.name for s in tr.spans()] == [f"s{i}" for i in range(12, 20)]
    assert tr.now_us() > 0


def test_disabled_mode_is_the_shared_no_op():
    assert not obs_trace.enabled()
    nulls = (obs_trace.span("a", big="tag"), obs_trace.span("b"), obs_trace.ambient(level="x"),
             obs_trace.annotate("c"), obs_trace.step_annotation(3))
    assert all(n is obs_trace.NULL_SPAN for n in nulls)
    with nulls[0] as s:
        s.tag(nbytes=1)

    @obs_trace.traced("d")
    def fn():
        return 5

    assert fn() == 5 and obs_trace.get_tracer().n_recorded == 0
    # tracing on without profiler annotations: the round marker stays a no-op
    obs_trace.enable()
    assert obs_trace.step_annotation(3) is obs_trace.NULL_SPAN
    assert obs_trace.annotate("c") is not obs_trace.NULL_SPAN


def test_export_jsonl_roundtrip(tmp_path):
    obs_trace.enable()
    with obs_trace.span("phase/x", nbytes=10):
        with obs_trace.span("phase/y"):
            pass
    obs_trace.set_meta(label="t", n_params=7)
    path = obs_trace.export_jsonl(str(tmp_path / "t.jsonl"))
    meta, spans = obs_trace.load_jsonl(path)
    assert meta["label"] == "t" and meta["n_params"] == 7
    assert meta["n_recorded"] == 2 and meta["n_evicted"] == 0
    assert meta["capacity"] == obs_trace.DEFAULT_CAPACITY
    assert [s.to_json() for s in spans] == [s.to_json() for s in obs_trace.get_tracer().spans()]
    assert spans[1].name == "phase/x" and spans[1].tags == {"nbytes": 10}
    assert spans[1].encloses(spans[0])


def test_chrome_trace_schema(tmp_path):
    obs_trace.enable()
    with obs_trace.span("a", level="intra"):
        with obs_trace.span("b"):
            pass
    obs_trace.set_meta(label="c")
    with open(obs_trace.export_chrome_trace(str(tmp_path / "t.json"))) as f:
        doc = json.load(f)
    assert len(doc["traceEvents"]) == 2 and doc["otherData"] == {"label": "c"}
    tid = obs_trace.get_tracer().spans()[0].tid
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and isinstance(ev["name"], str)
        assert isinstance(ev["ts"], (int, float)) and ev["dur"] >= 0
        assert ev["pid"] == os.getpid() and ev["tid"] == tid
    by_name = {ev["name"]: ev for ev in doc["traceEvents"]}
    assert by_name["a"]["args"] == {"level": "intra"} and by_name["b"]["args"] == {}


def test_jsonl_crosses_between_the_packages(tmp_path, ref_trace):
    """A trace written by either package loads in the other with equal
    spans (names, times, threads, depths, tags) and meta."""
    obs_trace.enable()
    with obs_trace.ambient(level="inter"):
        with obs_trace.span("codec/encode", nbytes=12, scheme="quant"):
            with obs_trace.span("codec/encode_chunk", index=0):
                pass
    obs_trace.set_meta(label="port", n_params=5)
    ours = obs_trace.export_jsonl(str(tmp_path / "port.jsonl"))
    meta, spans = ref_trace.load_jsonl(ours)
    mine = obs_trace.get_tracer().spans()
    assert [s.to_json() for s in spans] == [s.to_json() for s in mine]
    assert meta == obs_trace.load_jsonl(ours)[0] and meta["label"] == "port"

    ref_trace.enable()
    with ref_trace.ambient(level="intra"):
        with ref_trace.span("sync/pack", n=1):
            with ref_trace.span("inner"):
                pass
    ref_trace.set_meta(label="ref")
    theirs = ref_trace.export_jsonl(str(tmp_path / "ref.jsonl"))
    meta, spans = obs_trace.load_jsonl(theirs)
    want = ref_trace.get_tracer().spans()
    assert [s.to_json() for s in spans] == [s.to_json() for s in want]
    assert [(s.name, s.tid, s.depth, s.tags) for s in spans] == \
        [(s.name, s.tid, s.depth, s.tags) for s in want]
    assert meta["label"] == "ref" and spans[1].encloses(spans[0])


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def _synthetic_files(tmp_path):
    """A trace with every round phase (nested chunk spans included), serve
    spans, and a metrics JSON with the ledger, serve stats and fault series."""
    obs_trace.enable()
    for t in range(2):
        with obs_trace.span("round/step", round=t):
            for level in ("intra", "inter"):
                with obs_trace.ambient(level=level):
                    with obs_trace.span("sync/pack"):
                        time.sleep(0.0002)
                    with obs_trace.span("codec/encode", nbytes=100 + t, scheme="quant"):
                        with obs_trace.span("codec/encode_chunk", nbytes=50):
                            time.sleep(0.0002)
                    with obs_trace.span("comm/allreduce", nbytes=101):
                        time.sleep(0.0001)
                    with obs_trace.span("codec/decode", nbytes=101):
                        pass
                    with obs_trace.span("sync/adopt"):
                        pass
    for name in ("serve/admit", "serve/prefill", "serve/decode", "serve/decode"):
        with obs_trace.span(name):
            pass
    obs_trace.set_meta(label="synthetic", n_params=1 << 12, n_rounds=2,
                       sync={"mode": "hier", "compressor": "qsgd", "compress_ratio": 0.05,
                             "quant_bits": 8, "sync_period": 2, "topology": "v5p_superpod"})
    trace = obs_trace.export_jsonl(str(tmp_path / "TRACE_s.jsonl"))
    reg = obs_metrics.MetricsRegistry()
    for key, v in (("drops", 2), ("retries", 3), ("deadline_misses", 1)):
        reg.counter(f"faults/{key}").inc(v, step=0)
    reg.gauge("faults/survivor_frac/inter").set(0.75, step=0)
    reg.gauge("faults/round_time_s").set(0.0125, step=0)
    reg.counter("serve/admitted").inc(4)
    reg.gauge("serve/pool/resident").set(3)
    metrics = reg.export_json(str(tmp_path / "METRICS_s.json"), extra={
        "ledger_bytes_by_tag": {"intra": 201.0, "inter": 201.0, "retry": 7.0}})
    return trace, metrics


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0), path
    else:
        assert a == b, path


def test_build_report_equals_the_reference(tmp_path):
    from repro.obs import report as jreport
    trace, metrics = _synthetic_files(tmp_path)
    for kw in ({}, {"metrics_path": metrics}):
        jtext, jres = jreport.build_report(trace, **kw)
        ttext, tres = treport.build_report(trace, device="cpu", **kw)
        _assert_same(tres, jres)
        assert ttext == jtext
    assert tres["bytes_match"] is True and tres["fault_stats"]["drops"] == 2.0
    assert "degraded rounds" in ttext and "serving path" in ttext
    assert tres["serve_spans"]["serve/decode"]["n"] == 2
    # the CLI's modelled flags rebuild the same SyncConfig in both packages
    argv = [trace, "--mode", "efbv", "--compressor", "top_k", "--params", "4096"]
    assert jreport.main(argv + ["--json", str(tmp_path / "j.json")]) == 0
    assert treport.main(argv + ["--device", "cpu", "--json", str(tmp_path / "t.json")]) == 0
    got, want = (json.load(open(tmp_path / f"{n}.json")) for n in "tj")
    _assert_same(got, want)
    assert got["serial_model_s"] > 0


def test_phase_classification_outermost_only():
    obs_trace.enable()
    with obs_trace.span("codec/encode", nbytes=100, level="inter"):
        for c in range(2):
            with obs_trace.span("codec/encode_chunk", chunk=c, nbytes=50):
                pass
    spans = obs_trace.get_tracer().spans()
    outer = [s for s in spans if s.name == "codec/encode"][0]
    assert treport.measured_phase_seconds(spans)["encode"] == pytest.approx(outer.dur_us / 1e6)
    assert treport.measured_bytes_by_level(spans) == {"inter": 100.0}
    assert treport.phase_of("sync/bucketize") == "pack" and treport.phase_of("x") is None


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_traced_hier_round_audits_and_the_cli_fails_on_a_corrupted_ledger(tmp_path,
                                                                          chip_smoke):
    cpu = torch.device("cpu")
    trace, metrics = chip_smoke.traced_round(str(tmp_path), 1 << 13, "qsgd", cpu)
    assert not obs_trace.enabled()
    text, res = treport.build_report(trace, metrics_path=metrics, device="cpu")
    assert res["bytes_match"] is True and res["trace_bytes"] == res["ledger_bytes"]
    assert set(res["trace_bytes"]) == {"intra", "inter"}
    for phase in ("pack", "encode", "allreduce", "decode", "adopt"):
        assert res["measured_s"][phase] > 0.0, phase
    assert "per-level measured bytes match CommLedger: True" in text
    assert treport.main([trace, "--metrics", metrics, "--device", "cpu"]) == 0
    # the reference report reads the port's files to the same verdict
    from repro.obs import report as jreport
    assert jreport.build_report(trace, metrics_path=metrics)[1]["trace_bytes"] == \
        res["trace_bytes"]
    doc = json.load(open(metrics))
    doc["ledger_bytes_by_tag"]["inter"] += 1
    json.dump(doc, open(metrics, "w"))
    assert treport.main([trace, "--metrics", metrics, "--device", "cpu"]) == 1


def test_codec_spans_carry_the_ambient_level():
    from repro_torch.comm import codecs
    from repro_torch.core import compressors as C
    obs_trace.enable()
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    with obs_trace.ambient(level="inter"):
        p = codecs.encode(C.qsgd(8), x, generator=torch.Generator().manual_seed(1))
        codecs.decode(p, "cpu")
    spans = {s.name: s for s in obs_trace.get_tracer().spans()}
    assert spans["codec/encode"].tags["nbytes"] == p.nbytes
    assert spans["codec/encode"].tags["level"] == spans["codec/decode"].tags["level"] == "inter"
    assert spans["codec/decode"].tags["nbytes"] == p.nbytes


# ---------------------------------------------------------------------------
# logging and the training loop
# ---------------------------------------------------------------------------
KV_CASES = [
    ("round", dict(step=3, loss=2.3456789123, ce=1.0, grad_norm=1e-9)),
    ("evt", dict(name="a b", eq="x=y", empty="", plain="ok", flag=True, n=None)),
    ("big", dict(v=123456789.0, w=-0.0, i=-7, f=float("inf"))),
    ("bare", {}),
]


@pytest.mark.parametrize("event,kv", KV_CASES, ids=[c[0] for c in KV_CASES])
def test_format_kv_gives_the_reference_strings(event, kv):
    from repro.utils import logging as jlogging
    assert tlogging.format_kv(event, **kv) == jlogging.format_kv(event, **kv)


def test_get_logger_is_idempotent_and_honours_the_level(monkeypatch):
    monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
    name = "repro_torch.test.level"
    a = tlogging.get_logger(name)
    assert tlogging.get_logger(name) is a and len(a.handlers) == 1
    assert a.level == logging.WARNING and not a.propagate
    monkeypatch.setenv("REPRO_LOG_LEVEL", "15")
    assert tlogging.get_logger("repro_torch.test.numeric").level == 15


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_the_traced_loop_logs_round_lines_and_opens_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.training.loop import train

    cfg = get_config("h2o-danube-1.8b").reduced()
    tc = TrainConfig(model=cfg, seq_len=16, global_batch=2, lr=1e-3, warmup_steps=1,
                     total_steps=2)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=2000, seed=0)
    handler = _Records()
    logger = logging.getLogger("train")
    logger.addHandler(handler)
    shown = []
    try:
        obs_trace.enable(profiler_annotations=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, history = train(cfg, tc, lm_batch_iterator(ds, 2, 16, seed=1), steps=2,
                               log_every=1, device="cpu", log=shown.append)
        obs_trace.disable()
        # tracing off: no round line, and the caller's log= still gets the steps
        _, quiet = train(cfg, tc, lm_batch_iterator(ds, 2, 16, seed=1), steps=2,
                         log_every=1, device="cpu", log=shown.append)
    finally:
        logger.removeHandler(handler)
    rounds = [line for line in handler.lines if line.startswith("round ")]
    from repro.utils.logging import format_kv as jformat
    assert rounds == [jformat("round", step=i, **h) for i, h in enumerate(history)]
    assert quiet == history and len(shown) == 4 and shown[0].startswith("step    0 loss")
    names = [s.name for s in obs_trace.get_tracer().spans()]
    assert names.count("round/step") == 2 and names.count("round/blocking_fetch") == 2
    ranges = {e.name for e in prof.events()}
    assert {"train#0", "train#1", "round/step", "step/grad", "step/apply"} <= ranges
    assert len(obs_metrics.registry.gauge("train/loss").series) == 2


def test_the_loop_reads_no_time_clock():
    tree = ast.parse((ROOT / "src/repro_torch/training/loop.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert "time" not in names
