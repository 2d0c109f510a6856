"""Engine-1 AST rules. Importing this package registers every rule."""
from repro_torch.lint.rules import (  # noqa: F401 — registration side effects
    rl001_host_sync,
    rl002_randomness,
    rl003_wallclock,
    rl004_ledger_tags,
    rl005_tracer_branch,
)
