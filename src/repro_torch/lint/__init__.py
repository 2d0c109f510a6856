"""repro_torch.lint — the port's static analyzer (port of ``repro.lint``).

Two engines behind one CLI (``python -m repro_torch.lint``):

* **Engine 1** — AST rules RL001–RL005 over ``src/repro_torch`` +
  ``chip_smoke.py`` (host syncs on the hot path, unseeded randomness,
  wall-clock in modeled paths, unregistered ledger tags, branches on
  tensors), with per-line ``# repro: noqa[RULE]`` suppressions and a
  committed baseline.  AST only: it imports nothing it checks.
* **Engine 2** — contract checks RC001–RC003 (``contracts.py``, the only
  module that imports ``torch``): the compressor registry on the ``meta``
  device, payload-vs-accounting byte formulas, and the CUDA kernels' launch
  resources — statically from the constants in the ``.cu`` sources' text
  and, on the card, from the built library.
"""
from repro_torch.lint.framework import (  # noqa: F401
    Finding,
    Project,
    all_rules,
    apply_baseline,
    build_project,
    load_baseline,
    run_rules,
    write_baseline,
)
