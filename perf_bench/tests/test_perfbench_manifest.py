"""BENCHMARK.json against the benchmark's contract, discovery by name, and
the rule that nothing under perf_bench/ imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perf_bench.harness import bench

MAN = bench.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16 and len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")
    for word in MAN["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and not (group == "per_layer" and k == "source"):
                    assert TEXT.match(e[k]), (e["name"], k)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in MAN[group]]
        assert len(ns) == len(set(ns)), group
    metric_names = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perf_bench/") and (bench.ROOT / c["file"]).is_file()
        assert json.loads((bench.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in MAN["workloads"]} == {c["name"] for c in MAN["configs"]}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("wl", [w["name"] for w in MAN["workloads"]])
def test_every_cell_is_found_by_name_and_reports_enough(wl):
    cell = bench.load_json("cells", wl)
    w = bench.workload(MAN, wl)
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    bench.load_json("configs", cell["config"])
    bench.load_json("traffic", cell["traffic"])
    assert callable(bench.load_py("drivers", cell["driver"]).run)
    e2e = [m["name"] for m in bench.end_to_end(MAN, wl)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.per_layer(MAN, wl)
    assert layer
    for m in layer:
        assert callable(bench.load_py("metrics", m["name"]).read)
        assert m["moves"] in e2e, (m["name"], wl)
    assert set(cell["limits"])


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in MAN["per_layer"]:
        for wl in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            bench.workload(MAN, wl)
            assert m["moves"] in [e["name"] for e in bench.end_to_end(MAN, wl)], (m, wl)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH, root / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "danube-train-dense", "config": "h2o-danube-1.8b",
                             "traffic": "train-s1024-b8", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = bench.load_json("cells", "danube-train-efbv")
    cell.update(traffic="train-s1024-b8", sync={"mode": "dense"})
    (root / "perf_bench/cells/danube-train-dense.json").write_text(json.dumps(cell))
    (root / "perf_bench/traffic/train-s1024-b8.json").write_text(
        json.dumps({"kind": "train", "seq_len": 1024, "global_batch": 8}))
    monkeypatch.setattr(bench, "ROOT", root)
    monkeypatch.setattr(bench, "BENCH", root / "perf_bench")
    m = bench.manifest()
    assert bench.workload(m, "danube-train-dense")["traffic"] == "train-s1024-b8"
    assert bench.load_json("cells", "danube-train-dense")["sync"] == {"mode": "dense"}
    assert bench.load_json("traffic", "train-s1024-b8")["seq_len"] == 1024
    names = [x["name"] for x in bench.end_to_end(m, "danube-train-dense")]
    assert names == ["setup_s"]       # no end-to-end metric lists the new cell yet
    assert bench.load_py("drivers", "train").run


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    bad = []
    for p in sorted(bench.BENCH.rglob("*.py")):
        for name in _imports(p):
            if name.split(".")[0] in bench.FORBIDDEN:
                bad.append((str(p.relative_to(bench.ROOT)), name))
    assert not bad
    assert [n for n in ("repro_torch", "repro_torch.serve", "reprox", "jaxtyping")
            if n.split(".")[0] in bench.FORBIDDEN] == []


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "from perf_bench.harness import bench;"
            "import perf_bench.reference.train, perf_bench.harness.devtrace;"
            "[bench.load_py('drivers', d) for d in ('train', 'serve_closed')];"
            "[bench.load_py('metrics', m['name']) for m in bench.manifest()['per_layer']];"
            "import repro_torch.training.steps, repro_torch.serve;"
            "print(bench.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "perf_bench/run.py", "--workload", "danube-train-efbv",
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                         cwd=bench.ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
