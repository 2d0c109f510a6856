"""repro_torch.lint, the port's static analyzer, against repro.lint.

Each rule catches its torch fixture (sources written to ``tmp_path``, so the
default lint paths never see them); RL002-RL004 give the reference's
``(rule, line, col)`` findings on the reference's own fixtures
(``tests/lint_fixtures``, read as text: no JAX runs); ``Finding``'s
fingerprint, text and JSON and the baseline file are equal between the two
packages; the port's hot roots cover the reference's roots that exist in the
port; and the port lints clean, contracts included, with an empty baseline.
The card half of RC003 is ``cuda``-marked.  About 10 s on 2 threads.
"""
import io
import json
import os
import textwrap
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from repro_torch.lint import framework as tfw
from repro_torch.lint.__main__ import main as lint_main

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REF_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")

FIXTURES = {
    "bad_rl001.py": '''
        """RL001: host reads on the hot path."""
        import numpy as np
        import torch


        def make_toy_step(scale: float):
            def step(x):
                lo = x.min().item()              # RL001
                host = np.asarray(x)             # RL001
                return x * scale - lo + helper(x) + int(x)   # RL001: int(param)

            return step


        def helper(x):
            def on_done(y):
                return y.item()                  # RL001: a callback, reached with helper

            register(on_done)
            return x.sum().tolist()              # RL001: reachable from step


        class Square(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.cpu().numpy().sum()  # RL001 x2


        class Probe(torch.nn.Module):
            def forward(self, x):
                return x.to("cpu")               # RL001


        def cold(x):
            return x.item()                      # not reachable: no finding
        ''',
    "bad_rl001_expr.py": '''
        """RL001: casts of tensor expressions; a tensor's metadata is not one."""
        import torch


        def statistics(w: torch.Tensor, x: torch.Tensor, scale: float):
            aw = w.float().abs()
            mu = float((aw * x[:, None]).mean())    # RL001: float(expr)
            big = bool(torch.any(aw > scale))       # RL001: bool(torch.*(tensor))
            rows = int(w.shape[0])                  # metadata: no finding
            n = int(aw.numel()) + int(x.size(0))    # metadata: no finding
            return mu, big, rows, n, float(scale)   # a float argument: no finding


        def make_stats_step():
            def step(w, x):
                return statistics(w, x, 0.5)

            return step
        ''',
    "bad_rl002.py": '''
        """RL002: global RNG state."""
        import numpy as np
        import torch
        from torch import rand


        def noisy(shape, seed=0):
            torch.manual_seed(seed)              # RL002
            torch.cuda.manual_seed_all(seed)     # RL002
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(shape) + torch.randn(shape, generator=g)   # RL002 once
            b = rand(shape)                      # RL002
            m = torch.multinomial(a.abs().flatten(), 1)   # RL002
            return a + b + np.random.randn(*shape) + m    # RL002
        ''',
    "bad_rl003.py": '''
        """RL003: wall clock outside obs/ and chip_smoke.py."""
        import time
        from time import perf_counter


        def measure(fn):
            t0 = time.time()                     # RL003
            fn()
            return perf_counter() - t0           # RL003
        ''',
    "bad_rl004.py": '''
        """RL004: ledger records with missing or unregistered tags."""
        from repro_torch.comm.ledger import UPLOAD_TAG, CommLedger


        def account(nbytes):
            led = CommLedger()
            led.record(0, "a->b", nbytes, kind="inter", phase=0)  # RL004: no tag
            led.record(1, "a->b", nbytes, tag="bogus_tag")        # RL004
            led.record(2, "a->b", nbytes, tag=UPLOAD_TAG)
            return led
        ''',
    "bad_rl005.py": '''
        """RL005: branches on tensors in hot roots."""
        import torch


        def make_clip_step(limit: float):
            def step(x, mask=None):
                if mask is not None and x.dim() == 2:   # metadata: fine
                    x = x * mask
                y = x * limit
                if y.sum() > 0:                  # RL005
                    return y
                while x < 0:                     # RL005
                    x = x + 1
                return x

            return step


        class Gate(torch.nn.Module):
            def forward(self, x):
                if x.any():                      # RL005
                    return x
                return -x
        ''',
    "noqa_ok.py": '''
        """The violations above, each suppressed in place."""
        import time

        import torch


        def make_toy_step():
            def step(x):
                lo = x.min().item()  # repro: noqa[RL001]
                if x > 0:  # repro: noqa[RL005]
                    return x - lo
                return x

            return step


        def noisy(shape, led):
            t0 = time.time()  # repro: noqa[RL003]
            led.record(0, "a->b", 128)  # repro: noqa[RL004]
            return torch.randn(shape), t0  # repro: noqa[RL002]
        ''',
}


@pytest.fixture
def fixture_dir(tmp_path):
    for name, src in FIXTURES.items():
        (tmp_path / name).write_text(textwrap.dedent(src).lstrip())
    return tmp_path


def run_lint(*argv):
    """In-process CLI run, engine 1 only; returns (rc, findings-as-dicts)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = lint_main([*map(str, argv), "--format", "json", "--no-contracts"])
    return rc, json.loads(buf.getvalue())["findings"]


def _keys(findings, rules):
    return sorted((f.rule, f.line, f.col) for f in findings if f.rule in rules)


# ---------------------------------------------------------------------------
# engine 1: each rule catches its fixture; noqa; usage errors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture,rule,n_min", [
    ("bad_rl001.py", "RL001", 7),
    ("bad_rl002.py", "RL002", 6),
    ("bad_rl003.py", "RL003", 2),
    ("bad_rl004.py", "RL004", 2),
    ("bad_rl005.py", "RL005", 3),
])
def test_rule_catches_fixture(fixture_dir, fixture, rule, n_min):
    rc, findings = run_lint(fixture_dir / fixture)
    assert rc == 1
    assert len(findings) >= n_min, findings
    assert all(f["rule"] == rule for f in findings), findings


def test_rl001_roots_and_edges(fixture_dir):
    """The factory's nested def, the autograd.Function and nn.Module
    forwards are roots; a helper they call is reached, and so is a def
    nested in it that is only handed on as a callback; a cold function is
    not."""
    _, findings = run_lint(fixture_dir / "bad_rl001.py")
    text = " ".join(f["message"] for f in findings)
    for where in ("make_toy_step.step", "helper", "helper.on_done", "Square.forward",
                  "Probe.forward"):
        assert f"`{where}`" in text, where
    assert "`cold`" not in text


def test_rl001_casts_of_tensor_expressions(fixture_dir):
    """``float`` / ``bool`` of an expression over a reached helper's tensor
    arguments are findings; ``int`` of shapes and counts, and ``float`` of a
    float argument, are not (the narrowing to tensor values)."""
    rc, findings = run_lint(fixture_dir / "bad_rl001_expr.py")
    assert rc == 1
    assert [(f["rule"], f["line"]) for f in findings] == [("RL001", 7), ("RL001", 8)]
    assert "float((aw * x[:, None]).mean())" in findings[0]["message"]
    assert "`statistics`" in findings[1]["message"]


def test_rl005_exempts_metadata_and_none_checks(fixture_dir):
    _, findings = run_lint(fixture_dir / "bad_rl005.py")
    assert sorted(f["line"] for f in findings) == [10, 12, 21]


def test_rl004_names_known_tags(fixture_dir):
    _, findings = run_lint(fixture_dir / "bad_rl004.py")
    unregistered = [f for f in findings if "bogus_tag" in f["message"]]
    assert len(unregistered) == 1 and "serve/page_in" in unregistered[0]["message"]


def test_noqa_suppresses_each_rule(fixture_dir):
    rc, findings = run_lint(fixture_dir / "noqa_ok.py")
    assert rc == 0 and findings == []


def test_rule_filter_and_unknown_rule(fixture_dir):
    rc, findings = run_lint(fixture_dir, "--rules", "RL002")
    assert rc == 1 and {f["rule"] for f in findings} == {"RL002"}
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(buf):
        rc = lint_main([str(fixture_dir), "--rules", "RL999", "--no-contracts"])
    assert rc == 2


# ---------------------------------------------------------------------------
# parity with repro.lint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture", ["bad_rl002.py", "bad_rl003.py", "bad_rl004.py",
                                     "clean.py", "noqa_ok.py"])
def test_rl002_to_rl004_equal_the_reference_on_its_fixtures(fixture):
    from repro.lint import framework as rfw
    path = os.path.join(REF_FIXTURES, fixture)
    rules = ("RL002", "RL003", "RL004")
    ref = rfw.run_rules(rfw.build_project([path]), rules)
    port = tfw.run_rules(tfw.build_project([path]), rules)
    assert _keys(port, rules) == _keys(ref, rules)
    assert [f.path for f in port] == [f.path for f in ref]
    if fixture.startswith("bad_"):
        assert _keys(port, rules), fixture


def test_differences_from_the_reference_are_by_design(tmp_path):
    """RL003's allowed timing harness is ``chip_smoke.py`` in the port and
    ``benchmarks/common.py`` in the reference; RL002 flags torch's global
    RNG in the port and an argless ``jax.random.PRNGKey()`` in the
    reference."""
    from repro.lint import framework as rfw
    clock = "import time\n\n\ndef t():\n    return time.time()\n"
    (tmp_path / "benchmarks").mkdir()
    (tmp_path / "benchmarks" / "common.py").write_text(clock)
    (tmp_path / "chip_smoke.py").write_text(clock)
    (tmp_path / "rng.py").write_text(
        "import jax\nimport torch\n\n\ndef r():\n"
        "    return jax.random.PRNGKey(), torch.randn(3)\n")
    paths = [str(tmp_path)]

    def found(fw, rule):
        project = fw.build_project(paths, root=str(tmp_path))
        return sorted((f.path, f.line, f.col) for f in fw.run_rules(project, [rule]))

    assert found(rfw, "RL003") == [("chip_smoke.py", 5, 12)]
    assert found(tfw, "RL003") == [("benchmarks/common.py", 5, 12)]
    assert found(rfw, "RL002") == [("rng.py", 6, 12)]
    assert found(tfw, "RL002") == [("rng.py", 6, 34)]


def test_framework_output_and_baseline_equal_the_reference(tmp_path):
    from repro.lint import framework as rfw
    fields = ("RL001", "src/x.py", 7, 3, "a message", "y = x.item()")
    ref, port = rfw.Finding(*fields), tfw.Finding(*fields)
    assert port.fingerprint == ref.fingerprint
    assert port.format() == ref.format()
    assert port.to_json() == ref.to_json()
    other = tfw.Finding("RL003", "src/y.py", 1, 1, "m", "t = time.time()")
    tfw.write_baseline(str(tmp_path / "port.json"), [port, other])
    rfw.write_baseline(str(tmp_path / "ref.json"),
                       [ref, rfw.Finding("RL003", "src/y.py", 1, 1, "m", "t = time.time()")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    loaded = rfw.load_baseline(str(tmp_path / "port.json"))
    assert loaded == tfw.load_baseline(str(tmp_path / "ref.json"))
    fresh = tfw.Finding("RL002", "src/z.py", 2, 1, "m", "np.random.rand()")
    assert tfw.apply_baseline([port, fresh], loaded) == ([fresh], 1)
    assert rfw.apply_baseline([ref], loaded) == ([], 1)


def test_hot_roots_cover_the_reference_roots():
    """Every root of the reference's jit graph over src/repro whose
    (module, qualname), ``repro.`` read as ``repro_torch.``, exists in the
    port is a root of the port's graph; every HOT_ROOTS row resolves."""
    from repro.lint import framework as rfw
    from repro_torch.lint.callgraph import HOT_ROOTS
    ref = rfw.build_project([os.path.join(REPO, "src", "repro")]).callgraph
    port = tfw.build_project([os.path.join(REPO, "src", "repro_torch")]).callgraph
    mapped = [("repro_torch" + fn.module[len("repro"):], fn.qualname)
              for fn in ref.root_nodes()]
    present = [k for k in mapped if k in port.nodes]
    assert len(present) >= 13, present        # ops' 8 wrappers, the step factories' 5
    assert [k for k in present if not port.nodes[k].is_root] == []
    for module, qual, static in HOT_ROOTS:
        fn = port.nodes.get((module, qual))
        assert fn is not None and fn.is_root, (module, qual)
        assert set(static) <= set(fn.params()), (module, qual, static)
    for qual in ("make_prefill_step.prefill_step", "make_decode_step.decode_one"):
        assert port.nodes[("repro_torch.training.steps", qual)].is_root


# ---------------------------------------------------------------------------
# the port itself; the contracts
# ---------------------------------------------------------------------------
def test_repo_is_lint_clean():
    rc, findings = run_lint()               # the default paths
    assert rc == 0 and findings == [], findings
    buf = io.StringIO()
    with redirect_stdout(buf):
        lint_main(["--format", "json", "--no-contracts"])
    doc = json.loads(buf.getvalue())
    assert doc["baselined"] == 0 and doc["checked_files"] > 90
    assert {os.path.basename(p) for p in doc["paths"]} == {"repro_torch", "chip_smoke.py"}


def test_committed_baseline_is_empty():
    from repro_torch import lint as lint_pkg
    path = os.path.join(os.path.dirname(lint_pkg.__file__), "baseline.json")
    with open(path) as f:
        assert json.load(f) == {"fingerprints": []}


def test_contract_params_cover_registry():
    from repro_torch.core.compressors import _REGISTRY
    from repro_torch.lint.contracts import CONTRACT_PARAMS
    assert set(CONTRACT_PARAMS) == set(_REGISTRY)


def test_contracts_pass_on_the_cpu():
    from repro_torch.lint.contracts import run_contracts
    findings = run_contracts(device="cpu")
    assert findings == [], [f.format() for f in findings]


def test_static_launches_match_the_designed_b8_staging():
    """The .cu sources' constants give 256 threads a block, B6's 64 KiB ring
    and the selecting B8's 90,144 B staged at d_in 2560 and 8,224 B
    unstaged at 8192."""
    from repro_torch.lint.contracts import cu_constants, launch_table
    quant = cu_constants("quant.cu")
    assert (quant["kThreads"], quant["kSteps"], quant["kStreamSmem"]) == (256, 4, 65_536)
    assert "kFull" not in cu_constants("prune.cu")      # 0xffffffffu: left out
    rows = {(r.kid, r.d_in): r for r in launch_table() if r.kid in ("B6", "B8")}
    assert {r.threads for r in launch_table()} == {256}
    assert rows[("B6", 0)].smem == 65_536
    assert (rows[("B8", 2560)].smem, rows[("B8", 2560)].staged) == (90_144, True)
    assert (rows[("B8", 8192)].smem, rows[("B8", 8192)].staged) == (8_224, False)
    assert rows[("B8", 2560)].cluster == 4


def test_a_broken_mirror_is_a_finding(monkeypatch, tmp_path):
    """A copy of the sources whose B6 ring is four times deeper, and whose
    selecting B8 stages four times the keys a row: RC003's static half
    reads them and finds the ring over its budget and the ceiling, and B8
    staged otherwise than designed."""
    from repro_torch.lint import contracts
    for src in contracts.CSRC.glob("*.cu"):
        text = src.read_text()
        text = text.replace("kStages = 2;", "kStages = 8;")
        text = text.replace("kStagedRowSmem = kStrip * 4;", "kStagedRowSmem = kStrip * 16;")
        (tmp_path / src.name).write_text(text)
    monkeypatch.setattr(contracts, "CSRC", tmp_path)
    msgs = [f.message for f in contracts.check_kernel_budgets("cpu")]
    assert any("stream_quant_pack_kernel: 262144 B" in m and "budget" in m for m in msgs)
    assert any("262144 B" in m and "ceiling" in m for m in msgs)
    assert any("d_in 2560: staged=False, designed staged=True" in m for m in msgs)


def test_cli_contracts_need_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device defaults to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with redirect_stdout(io.StringIO()):
            lint_main([os.path.join(REF_FIXTURES, "clean.py")])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none present)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_resources_on_the_card(cuda_device):
    """RC003's card half: every kernel instance's library report matches its
    mirror, within budget, resident; the full contracts pass on the card."""
    from repro_torch.lint import contracts
    rows = contracts.kernel_resources(cuda_device)
    assert {r["launch"].kid for r in rows} == {f"B{i}" for i in range(1, 9)}
    assert all(r["occupancy"] > 0 and r["regs"] > 0 for r in rows)
    findings = contracts.run_contracts(cuda_device)
    assert findings == [], [f.format() for f in findings]
