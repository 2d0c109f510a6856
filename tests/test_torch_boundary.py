"""The port's boundary: it imports neither JAX nor the JAX package, entry
points default to the card, and ``chip_smoke.py`` refuses to run without one.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                 for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_the_scan_covers_every_ported_module():
    for name in ("repro_torch.core.ef_bv", "repro_torch.core.scafflix",
                 "repro_torch.core.fedp3", "repro_torch.core.sppm",
                 "repro_torch.data.federated", "repro_torch.configs.qwen1_5_4b",
                 "repro_torch.examples.federated_logreg", "repro_torch.examples.prune_llm",
                 "repro_torch.cohort.population", "repro_torch.cohort.engine",
                 "repro_torch.cohort.accounting", "repro_torch.faults.transmit",
                 "repro_torch.obs.metrics", "repro_torch.models.mamba",
                 "repro_torch.models.moe", "repro_torch.configs.mamba2_2_7b",
                 "repro_torch.configs.seamless_m4t_large_v2",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.dbrx_132b",
                 "repro_torch.configs.jamba_1_5_large_398b",
                 "repro_torch.examples.serve_decode", "repro_torch.obs.report",
                 "repro_torch.utils.logging", "repro_torch.lint.framework",
                 "repro_torch.lint.callgraph", "repro_torch.lint.contracts",
                 "repro_torch.lint.__main__", "repro_torch.lint.rules.rl002_randomness",
                 "repro_torch.sharding.rules", "repro_torch.sharding.context",
                 "repro_torch.launch.mesh", "repro_torch.launch.specs",
                 "repro_torch.launch.dryrun"):
        assert name in MODULES, name


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_the_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.comm.codecs import decode, encode
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import make_compressor
    from repro_torch.interop import params_from_jax
    from repro_torch.launch.serve import main
    from repro_torch.models import init_params

    cfg = get_config("h2o-danube-1.8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "h2o-danube-1.8b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"a": torch.zeros(2).numpy()})
    p = encode(make_compressor("identity"), torch.ones(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode(p)
    from repro_torch.core.ef_bv import efbv_init
    from repro_torch.core.fedp3 import FedP3Config, fedp3_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        efbv_init(4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fedp3_train(FedP3Config(), [], [], [4, 2], 1, None, None)
    from repro_torch.cohort import CohortEngine, Population, message_nbytes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortEngine(Population(n_clients=100), cohort_size=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        message_nbytes(make_compressor("identity"), 8)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    assert "no card" in r.stderr
