"""RL004 — untagged or unregistered ``CommLedger.record*`` tags.

Port of ``repro/lint/rules/rl004_ledger_tags.py``.
``CommLedger.bytes_by_tag()`` is the per-level / per-purpose byte
attribution the obs report audits against; a free-typed tag string silently
forks the attribution namespace ("retry" vs "retries").  The rule requires:

* every ledger-looking ``.record(...)`` call carries a ``tag=`` (positional
  arg 6 counts); ``record_payload``/``record_stream`` may omit it — they
  default to the payload's wire scheme, which is registered;
* a *literal* tag must resolve to a constant registered in
  ``src/repro_torch/comm/ledger.py`` (``*_TAG`` constants and the members
  of any ``*TAGS*`` frozenset literal);
* name references ending in ``_TAG`` and dynamic expressions (level names,
  f-strings) are accepted — those resolve at runtime.

"Ledger-looking" means a ``.record(...)`` with >= 3 positional args or any
of the ledger keywords — this skips ``obs`` ``tracer.record(span)``.
``comm/ledger.py`` itself and ``obs/`` are exempt.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from repro_torch.lint.framework import Finding, Project, rule

_LEDGER_KW = {"nbytes", "kind", "phase", "tag", "chunk", "link", "round"}
_TAG_ARG_POS = 5  # record(round, link, nbytes, kind, phase, tag, chunk)
_LEDGER_REL = "src/repro_torch/comm/ledger.py"


def _registered_tags(project: Project) -> Optional[Set[str]]:
    """Tag constants parsed out of comm/ledger.py (AST, no import needed).
    None when the ledger source can't be found — literal tags are then
    unverifiable and only missing/empty tags are flagged."""
    ctx = project.files.get(_LEDGER_REL)
    tree = ctx.tree if ctx is not None else None
    if tree is None:
        path = os.path.join(project.root, _LEDGER_REL)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    tags: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not names:
            continue
        if any(n.endswith("_TAG") for n in names) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            tags.add(node.value.value)
        if any("TAGS" in n for n in names):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                    tags.add(sub.value)
    return tags or None


def _tag_expr(node: ast.Call):
    """(present, expr) for the tag argument of a .record call."""
    for kw in node.keywords:
        if kw.arg == "tag":
            return True, kw.value
    if len(node.args) > _TAG_ARG_POS:
        return True, node.args[_TAG_ARG_POS]
    return False, None


def _exempt(relpath: str) -> bool:
    return (relpath == _LEDGER_REL
            or relpath.startswith("src/repro_torch/obs/")
            or relpath.startswith("tests/") and "lint_fixtures" not in relpath)


@rule("RL004", "CommLedger.record* without a tag, or with a literal tag not "
               "registered in comm/ledger.py")
def check(project: Project) -> List[Finding]:
    known = _registered_tags(project)
    out: List[Finding] = []
    for ctx in project.files.values():
        if _exempt(ctx.relpath):
            continue
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("record", "record_payload",
                                           "record_stream")):
                continue
            ledger_like = (node.func.attr != "record"
                           or len(node.args) >= 3
                           or any(kw.arg in _LEDGER_KW
                                  for kw in node.keywords))
            if not ledger_like:
                continue
            present, expr = _tag_expr(node)
            if not present:
                if node.func.attr == "record":
                    out.append(ctx.finding(
                        "RL004", node,
                        "ledger.record(...) without tag=: bytes land in the "
                        "empty-tag bucket of bytes_by_tag()"))
                continue  # record_payload/record_stream default to the scheme
            if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
                if not expr.value:
                    out.append(ctx.finding(
                        "RL004", node, "empty literal tag"))
                elif known is not None and expr.value not in known:
                    out.append(ctx.finding(
                        "RL004", node,
                        f"tag {expr.value!r} is not a registered constant in "
                        f"comm/ledger.py (known: {', '.join(sorted(known))})"))
            # Name/Attribute ending _TAG and dynamic expressions: accepted
    return out
