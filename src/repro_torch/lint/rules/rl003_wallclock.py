"""RL003 — wall-clock reads in modeled paths.

Port of ``repro/lint/rules/rl003_wallclock.py``.  Round times in this repo
are *modeled* (``topology.time_s``, pipelined
stream timing, deadline order statistics); real host clocks belong to the
observability layer.  A stray ``time.time()`` in a costing or training path
is either dead weight or — worse — quietly mixed into modeled numbers.

Allowed locations: ``src/repro_torch/obs/`` (the flight recorder owns the
host clock, exported as ``repro_torch.obs.trace.wall_s``) and
``chip_smoke.py`` (the port's check on the card, which times its phases and
the kernels alone).  Everything else must route through ``wall_s``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.callgraph import dotted
from repro_torch.lint.framework import Finding, Project, rule

_CLOCK_FNS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
              "monotonic_ns", "clock", "process_time", "process_time_ns"}
_ALLOWED_PREFIXES = ("src/repro_torch/obs/",)
_ALLOWED_FILES = ("chip_smoke.py",)


def _allowed(relpath: str) -> bool:
    if "lint_fixtures" in relpath:  # the linter's own test corpus IS linted
        return False
    return (relpath.startswith(_ALLOWED_PREFIXES)
            or relpath in _ALLOWED_FILES
            or relpath.startswith("tests/") or "/tests/" in relpath)


@rule("RL003", "wall-clock read (time.time/perf_counter) outside obs/ and "
               "chip_smoke.py")
def check(project: Project) -> List[Finding]:
    graph = project.callgraph
    out: List[Finding] = []
    for ctx in project.files.values():
        if _allowed(ctx.relpath):
            continue
        time_aliases = {a for a, m in
                        graph.mod_aliases.get(ctx.module, {}).items()
                        if m == "time"}
        froms = graph.from_imports.get(ctx.module, {})
        from_clocks = {name for name, (mod, orig) in froms.items()
                       if mod == "time" and orig in _CLOCK_FNS}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            parts = d.split(".")
            hit = None
            if len(parts) == 2 and parts[0] in time_aliases \
                    and parts[1] in _CLOCK_FNS:
                hit = d
            elif len(parts) == 1 and parts[0] in from_clocks:
                hit = f"time.{froms[parts[0]][1]}"
            if hit:
                out.append(ctx.finding(
                    "RL003", node,
                    f"{hit}() in a modeled path; use "
                    f"repro_torch.obs.trace.wall_s"))
    return out
