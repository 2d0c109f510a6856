"""RL002 — unseeded randomness.

Port of ``repro/lint/rules/rl002_randomness.py``.  The port's replay claims
(``round_plan(rnd)`` from ``(seed, round)`` alone, bit-identical reruns, the
card and the CPU fed the same draws) die the moment any code path draws from
global RNG state.  Flags:

* ``np.random.<sampler>(...)`` — the legacy global-state API (including
  ``np.random.seed``: global seeding is still shared mutable state);
* ``np.random.default_rng()`` / ``Generator``/``PCG64``/... constructors
  called with **no** seed argument;
* stdlib ``random.<fn>(...)`` module-level calls (``random.Random(seed)``
  instances are fine);
* the torch counterparts of global RNG state: ``torch.rand`` / ``randn`` /
  ``randint`` / ``randperm`` / ``bernoulli`` / ``multinomial`` / ``normal``
  called without ``generator=``, and global seeding
  (``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed[_all]``)
  — the counterparts of ``np.random.seed`` and of an argless ``PRNGKey()``.

Exempt: ``faults/model.py`` (the counter-PRNG implementation itself) and
anything under ``tests/``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.callgraph import dotted
from repro_torch.lint.framework import Finding, Project, rule

# numpy.random constructors that are fine *when given a seed*
_SEEDED_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "SFC64", "BitGenerator", "RandomState"}
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                   "multinomial", "normal"}
# torch's global seeding, relative to the torch module
_TORCH_SEEDING = {"manual_seed", "seed", "random.manual_seed", "random.seed",
                  "cuda.manual_seed", "cuda.manual_seed_all"}


def _exempt(relpath: str) -> bool:
    if "lint_fixtures" in relpath:  # the linter's own test corpus IS linted
        return False
    return (relpath.endswith("faults/model.py")
            or relpath.startswith("tests/")
            or "/tests/" in relpath)


def _alias_of(graph, module: str, target: str) -> set:
    return {alias for alias, mod in graph.mod_aliases.get(module, {}).items()
            if mod == target}


def _torch_finding(ctx, node: ast.Call, name: str):
    """The finding for torch function ``name`` (dotted below ``torch``), or
    None when the call is seeded."""
    if name in _TORCH_SAMPLERS:
        if any(kw.arg == "generator" for kw in node.keywords):
            return None
        return ctx.finding("RL002", node,
                           f"torch.{name} without generator=: draws from the "
                           f"global RNG; pass an explicit torch.Generator")
    if name in _TORCH_SEEDING:
        return ctx.finding("RL002", node,
                           f"torch.{name}: seeds the global RNG; seed an explicit "
                           f"torch.Generator instead")
    return None


@rule("RL002", "unseeded randomness (np.random.*, stdlib random, torch's global "
               "RNG) outside faults/model.py and tests")
def check(project: Project) -> List[Finding]:
    graph = project.callgraph
    out: List[Finding] = []
    for ctx in project.files.values():
        if _exempt(ctx.relpath):
            continue
        np_aliases = _alias_of(graph, ctx.module, "numpy")
        rand_aliases = _alias_of(graph, ctx.module, "random")
        torch_aliases = _alias_of(graph, ctx.module, "torch")
        froms = graph.from_imports.get(ctx.module, {})
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            parts = d.split(".")
            has_args = bool(node.args or node.keywords)
            # numpy.random.*
            if len(parts) >= 3 and parts[0] in np_aliases and parts[1] == "random":
                name = parts[2]
                if name in _SEEDED_CTORS:
                    if not has_args:
                        out.append(ctx.finding(
                            "RL002",
                            node, f"np.random.{name}() without a seed: "
                                  f"draws from OS entropy, run is not replayable"))
                else:
                    out.append(ctx.finding(
                        "RL002", node,
                        f"np.random.{name}: global-state RNG; use "
                        f"np.random.default_rng(seed)"))
                continue
            # from numpy import random as npr -> npr.rand(...)
            if len(parts) == 2 and froms.get(parts[0]) == ("numpy", "random"):
                name = parts[1]
                if name in _SEEDED_CTORS and has_args:
                    continue
                out.append(ctx.finding(
                    "RL002", node,
                    f"numpy.random.{name}: global-state or unseeded RNG"))
                continue
            # stdlib random module
            if len(parts) == 2 and parts[0] in rand_aliases:
                if parts[1] in ("Random", "SystemRandom") and has_args:
                    continue
                out.append(ctx.finding(
                    "RL002", node,
                    f"random.{parts[1]}: stdlib global-state RNG; seed an "
                    f"explicit random.Random(seed)"))
                continue
            # torch.<sampler> / torch.<seeding>, or one imported from torch
            if parts[0] in torch_aliases:
                f = _torch_finding(ctx, node, ".".join(parts[1:]))
            elif parts[0] in froms and froms[parts[0]][0].split(".")[0] == "torch":
                mod, orig = froms[parts[0]]
                f = _torch_finding(ctx, node, ".".join(
                    mod.split(".")[1:] + [orig] + parts[1:]))
            else:
                f = None
            if f is not None:
                out.append(f)
    return out
