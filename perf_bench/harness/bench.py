"""Discovery by name, the run record the metric readers read, and the
result line.

Everything that belongs to one cell, configuration, traffic mix, driver or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

    perf_bench/cells/<cell>.json        the cell: config, traffic, driver,
                                        the driver's options, the limits
    perf_bench/configs/<config>.json    published sizes, source, reductions
    perf_bench/families/<family>.py     a family's leaves, program fields,
                                        reference layers and flop counts
    perf_bench/traffic/<traffic>.json   the parameters of the traffic mix
    perf_bench/drivers/<driver>.py      run(ctx) -> Run
    perf_bench/metrics/<metric>.py      read(run) -> number or None
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perf_bench"
CACHE = ROOT / "_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    libraries that could load JAX told not to."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


_LOADED: Dict[Path, object] = {}


def load_py(kind: str, name: str):
    """The module ``perf_bench/<kind>/<name>.py`` (names may hold dots),
    loaded once per file."""
    path = BENCH / kind / f"{name}.py"
    if path in _LOADED:
        return _LOADED[path]
    mod_name = f"perf_bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


def _covers(metric: dict, wl: str) -> bool:
    return "workloads" not in metric or wl in metric["workloads"]


def end_to_end(man: dict, wl: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in man["end_to_end"] if _covers(m, wl)]


def per_layer(man: dict, wl: str) -> List[dict]:
    """The per-layer metrics this cell's traced run reports."""
    e2e = {m["name"] for m in end_to_end(man, wl)}
    return [m for m in man["per_layer"]
            if (wl in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_loaded() -> List[str]:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a driver gets: the cell and its files, the run's arguments."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                         # process start (host clock)
    control: bool = False


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    """A driver's record of one run, which the metric readers read."""
    metrics: Dict[str, float] = field(default_factory=dict)      # end to end
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window_s: float = 0.0
    spans: List[Tuple[str, float, Optional[float]]] = field(default_factory=list)
    series: Dict[str, list] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)
    trace: object = None              # devtrace.DeviceTrace of the window
    config: dict = field(default_factory=dict)
    cell: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    control: List[Check] = field(default_factory=list)   # the float8 reference's numbers

    def span_ms(self, name: str) -> List[float]:
        """Device milliseconds of every span of that name in the window."""
        return [d for n, _, d in self.spans if n == name and d is not None]


def limit_check(cell: dict, name: str, value: float) -> Check:
    return Check(name, float(value), float(cell["limits"][name]))


def device_info(count: int, peak: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], control: bool = False) -> dict:
    """The last line; with ``control`` the float8 reference stands in the
    program's place: its numbers are judged under the same limits."""
    checks = run.control if control else run.checks
    out = {"correct": bool(checks) and all(c.ok for c in checks) and run.failed == 0
           and run.attempted > 0,
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def print_checks(checks: List[Check], label: str = "check") -> None:
    for c in checks:
        print(f"{label} {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr, flush=True)


def now() -> float:
    return time.perf_counter()
