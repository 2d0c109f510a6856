"""Configuration families as files: each configuration's family module and
its contract, its layout and flop counts against the record the shared
harness left before the families were split out of it, no family branch
anywhere else in ``perf_bench``, and a family added as a file alone."""
from __future__ import annotations

import ast
import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from perf_bench.harness import bench, compare
from perf_bench.harness.weights import leaf_specs, make_weights
from perf_bench.metrics import counts
from perf_bench.reference import model as ref_model
from perf_bench.reference import train as ref_train
from perf_bench.tests import small

CONTRACT = ("block_leaves", "program_fields", "hidden", "body_weights", "mixer_flops",
            "POSITIONAL", "reduced")
CONFIGS = sorted(p.stem for p in (bench.BENCH / "configs").glob("*.json"))
RECORD = json.loads((bench.BENCH / "tests" / "layout_record.json").read_text())["configs"]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_has_a_family_with_the_contract(name):
    mod = bench.load_py("families", bench.load_json("configs", name)["family"])
    assert Path(mod.__file__).parent == bench.BENCH / "families"
    missing = [k for k in CONTRACT if not hasattr(mod, k)]
    assert not missing, (mod.__file__, missing)
    assert isinstance(mod.POSITIONAL, bool)


@pytest.mark.parametrize("name", sorted(RECORD))
def test_layout_and_counts_equal_the_record(name):
    cfg, rec = bench.load_json("configs", name), RECORD[name]
    got = [[s.path, list(s.shape), s.dtype, s.init, s.std, s.pert] for s in leaf_specs(cfg)]
    assert got == rec["leaf_specs"]
    c = rec["counts"]
    assert counts.body_weights(cfg) == c["body_weights"]
    assert [counts.mixer_flops(cfg, n) for n in c["ctx"]] == c["mixer_flops"]
    assert [counts.token_flops(cfg, n, lg) for n in c["ctx"] for lg in (False, True)] \
        == c["token_flops"]
    assert [counts.train_step_flops(cfg, 4096, 2), counts.train_step_flops(cfg, 48, 1)] \
        == c["train_step_flops"]
    assert small.reduced_config(name) == rec["reduced_config"]


def _reads_family(node: ast.AST) -> bool:
    return any((isinstance(n, ast.Constant) and n.value == "family")
               or (isinstance(n, ast.Attribute) and n.attr == "family")
               or (isinstance(n, ast.Name) and n.id == "family") for n in ast.walk(node))


def _names_family_module(call: ast.AST, arg: ast.AST) -> bool:
    """``arg`` is the name in ``bench.load_py("families", <arg>)``."""
    return (isinstance(call, ast.Call) and len(call.args) == 2 and call.args[1] is arg
            and isinstance(call.args[0], ast.Constant) and call.args[0].value == "families"
            and getattr(call.func, "attr", getattr(call.func, "id", None)) == "load_py")


def test_no_module_outside_families_branches_on_a_family():
    """Outside ``families/`` a configuration's family is read only as the
    name of its module: no comparison with a family's name, no table keyed
    by one, no other read of ``["family"]``."""
    families = {p.stem for p in (bench.BENCH / "families").glob("*.py")}
    assert {"dense", "ssm"} <= families
    bad = []
    for path in sorted(bench.BENCH.rglob("*.py")):
        rel = path.relative_to(bench.BENCH)
        if rel.parts[0] == "families":
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        parent = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                ops = [node.left] + node.comparators
                named = {n.value for o in ops for n in ast.walk(o) if isinstance(n, ast.Constant)}
                if named & families and any(_reads_family(o) for o in ops):
                    bad.append((str(rel), node.lineno, "compare"))
            elif isinstance(node, ast.Dict):
                if {k.value for k in node.keys if isinstance(k, ast.Constant)} & families:
                    bad.append((str(rel), node.lineno, "table"))
            elif (isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant)
                  and node.slice.value == "family"
                  and not isinstance(node.ctx, ast.Store)
                  and not _names_family_module(parent.get(node), node)):
                bad.append((str(rel), node.lineno, "read"))
    assert not bad


SCALED = '''"""A dense family whose published model scales its logits by 1/16."""
from perf_bench.harness import bench
from perf_bench.reference import model

_dense = bench.load_py("families", "dense")
block_leaves, program_fields, hidden = _dense.block_leaves, _dense.program_fields, _dense.hidden
body_weights, mixer_flops, POSITIONAL = _dense.body_weights, _dense.mixer_flops, True
reduced = _dense.reduced


def logits(params, cfg, h, fp8=False):
    return model.mm(h, params["embed/unembed"][:, : cfg["vocab_size"]], fp8) / 16.0
'''


def test_a_family_added_as_a_file_is_found_without_an_edit(tmp_path, monkeypatch):
    """A new family is one file in ``families/``: the layout, the program's
    configuration, the counts and the reference (its own ``logits``
    included) all reach it by the configuration's ``family``."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH, root / "perf_bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "perf_bench/families/scaled.py").write_text(SCALED)
    monkeypatch.setattr(bench, "BENCH", root / "perf_bench")
    dense = small.reduced_config("h2o-danube-1.8b")
    cfg = dict(dense, family="scaled")
    assert leaf_specs(cfg) == leaf_specs(dense)
    assert dataclasses.asdict(compare.program_config(cfg)) \
        == dataclasses.asdict(compare.program_config(dense))
    assert counts.train_step_flops(cfg, 8, 2) == counts.train_step_flops(dense, 8, 2)
    specs = leaf_specs(cfg)
    params = ref_train.param_views(make_weights(small.SEED, cfg, "cpu").flat_f32(), specs)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 9), generator=torch.Generator().manual_seed(4))
    h = ref_model.hidden(params, cfg, tokens)
    torch.testing.assert_close(h, ref_model.hidden(params, dense, tokens), rtol=0, atol=0)
    torch.testing.assert_close(ref_model.logits(params, cfg, h),
                               ref_model.logits(params, dense, h) / 16.0, rtol=0, atol=0)
