"""Shared scaffolding for the port's static analyzer (``python -m repro_torch.lint``).

Port of ``repro/lint/framework.py``, with the same findings, fingerprints,
suppressions and baseline format.  Engine 1 rules (``repro_torch.lint.rules``)
are AST passes over a :class:`Project` — every parsed file plus the import
maps and the hot-root call graph the rules share.  This module owns
everything that is not rule logic:

* file discovery + parsing into :class:`FileCtx` objects;
* :class:`Finding` and its stable *fingerprint* (rule + repo-relative path +
  the stripped source line, deliberately line-number-free so a baseline
  survives unrelated edits above the finding);
* per-line ``# repro: noqa[RL001]`` / ``# repro: noqa[RL001,RL004]``
  suppressions;
* the committed-baseline file (JSON list of fingerprints).

Rules register themselves via :func:`rule` and implement
``run(project) -> list[Finding]``; the CLI in ``__main__`` wires discovery,
suppression, baseline filtering and exit codes together.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Set

NOQA_RE = re.compile(r"#\s*repro:\s*noqa\[([A-Za-z0-9_,\s]+)\]")

# directories never linted even when a parent path is given
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}

# the checkout that holds this package: src/repro_torch/lint/ -> the root
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line:col RULE message``.

    ``snippet`` is the stripped source line the finding sits on; it anchors
    the fingerprint so baselines don't churn when line numbers shift.
    """
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.snippet}"

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fingerprint": self.fingerprint}


@dataclass
class FileCtx:
    """One parsed source file."""
    path: str              # absolute
    relpath: str           # repo-relative, forward slashes
    module: str            # dotted module name ("repro_torch.comm.ledger", ...)
    source: str
    lines: List[str]
    tree: ast.AST

    def noqa_rules(self, lineno: int) -> Set[str]:
        """Rule names suppressed on ``lineno`` (1-based)."""
        if 1 <= lineno <= len(self.lines):
            m = NOQA_RE.search(self.lines[lineno - 1])
            if m:
                return {r.strip().upper() for r in m.group(1).split(",")
                        if r.strip()}
        return set()

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0) + 1
        return Finding(rule, self.relpath, line, col, message,
                       self.snippet(line))


@dataclass
class Project:
    """Every file under the linted paths, plus lazily-built shared analyses."""
    root: str                              # repo root (absolute)
    files: Dict[str, FileCtx] = field(default_factory=dict)  # by relpath
    parse_errors: List[Finding] = field(default_factory=list)
    _callgraph: Optional[object] = None

    def add_file(self, path: str) -> None:
        path = os.path.abspath(path)
        rel = os.path.relpath(path, self.root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 1) or 1
            self.parse_errors.append(Finding(
                "PARSE", rel, line, 1, f"cannot parse: {e.__class__.__name__}: {e}"))
            return
        self.files[rel] = FileCtx(path, rel, _module_name(rel), source,
                                  source.splitlines(), tree)

    @property
    def callgraph(self):
        if self._callgraph is None:
            from repro_torch.lint.callgraph import CallGraph
            self._callgraph = CallGraph.build(self)
        return self._callgraph


def _module_name(relpath: str) -> str:
    """Dotted module name for a repo-relative path (best effort):
    ``src/repro_torch/comm/ledger.py`` -> ``repro_torch.comm.ledger``."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = p.split("/")
    if parts[:2] == ["src", "repro_torch"]:
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def find_repo_root(paths: Iterable[str]) -> str:
    """Nearest ancestor of the linted paths containing ``src/repro_torch``
    (falls back to the checkout that holds this package) — anchors
    repo-relative fingerprints and the ledger tag-registry lookup,
    independent of where the CLI is invoked from."""
    for p in list(paths) + [os.getcwd()]:
        d = os.path.abspath(p)
        if os.path.isfile(d):
            d = os.path.dirname(d)
        while True:
            if os.path.isdir(os.path.join(d, "src", "repro_torch")):
                return d
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return _PACKAGE_ROOT


def build_project(paths: Iterable[str], root: Optional[str] = None) -> Project:
    paths = list(paths)
    project = Project(root=os.path.abspath(root or find_repo_root(paths)))
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                project.add_file(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    project.add_file(os.path.join(dirpath, fn))
    return project


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------
_RULES: Dict[str, "Rule"] = {}


@dataclass(frozen=True)
class Rule:
    name: str
    description: str
    run: Callable[[Project], List[Finding]]


def rule(name: str, description: str):
    """Decorator registering ``fn(project) -> list[Finding]`` as a rule."""
    def deco(fn):
        _RULES[name] = Rule(name, description, fn)
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    import repro_torch.lint.rules  # noqa: F401 — registration side effect
    return dict(_RULES)


def run_rules(project: Project, names: Optional[Iterable[str]] = None
              ) -> List[Finding]:
    """Run engine-1 rules, dropping findings suppressed by an inline noqa."""
    rules = all_rules()
    selected = [rules[n] for n in (names or sorted(rules))]
    findings = list(project.parse_errors)
    for r in selected:
        for f in r.run(project):
            ctx = project.files.get(f.path)
            if ctx is not None and f.rule in ctx.noqa_rules(f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> Set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return set(doc.get("fingerprints", []))


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"fingerprints": fps}, f, indent=1)
        f.write("\n")


def apply_baseline(findings: List[Finding], baseline: Set[str]
                   ) -> "tuple[List[Finding], int]":
    """Returns (fresh findings, number suppressed by the baseline)."""
    fresh = [f for f in findings if f.fingerprint not in baseline]
    return fresh, len(findings) - len(fresh)
