"""RL005 — Python branching on a tensor in a hot root.

Port of ``repro/lint/rules/rl005_tracer_branch.py``.  ``if x > 0:`` on a
CUDA tensor calls ``Tensor.__bool__``: an implicit ``.item()`` that waits
for the stream, and a branch a CUDA graph cannot capture.  The rule taints
the parameters of every hot root (minus its static params), propagates
taint through simple assignments, and flags ``if``/``while`` tests that
would read a tainted name back to the host.

Not flagged (no device read):
* ``x.shape`` / ``x.ndim`` / ``x.dtype`` / ``x.size()`` / ``x.dim()`` /
  ``x.numel()`` / ``x.device`` / ``x.is_cuda`` / ``x.requires_grad`` /
  ``len(x)`` — metadata the host holds;
* ``x is None`` / ``x is not None`` — an optional-argument check;
* branches on closure/config values — only root *parameters* seed taint.

Non-root helpers are not analyzed: their arguments routinely mix tensors
with static config, and a name-based pass can't tell them apart.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.lint.framework import Finding, Project, rule

_META_ATTRS = {"shape", "ndim", "dtype", "size", "aval", "weak_type",
               "device", "is_cuda", "requires_grad", "dim", "numel"}


def _is_none_check(node: ast.AST) -> bool:
    return (isinstance(node, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
            and any(isinstance(c, ast.Constant) and c.value is None
                    for c in node.comparators))


def _offending_names(test: ast.AST, tainted: Set[str]) -> List[ast.Name]:
    """Tainted Name loads in ``test`` that would read a tensor back."""
    hits: List[ast.Name] = []

    def walk(node):
        if _is_none_check(node):
            return
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            return  # x.shape[...] etc — held on the host
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("len", "isinstance",
                                                    "getattr", "hasattr"):
                return
            if isinstance(f, ast.Attribute) and f.attr in _META_ATTRS:
                return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in tainted:
            hits.append(node)
            return
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(test)
    return hits


def _mentions_taint(expr: ast.AST, tainted: Set[str]) -> bool:
    return bool(_offending_names(expr, tainted))


def _body_nodes(fn_node: ast.AST):
    """Walk a function body without descending into nested defs — those are
    their own call-graph nodes (and, in step factories, their own roots)."""
    stack = [n for n in getattr(fn_node, "body", [])
             if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def _bound_names(target: ast.AST):
    """Names an assignment to ``target`` binds or mutates: ``y``, each of
    ``a, b``, and the object of ``buf[i]`` / ``obj.x`` (not its index)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _bound_names(elt)
    elif isinstance(target, (ast.Starred, ast.Subscript, ast.Attribute)):
        yield from _bound_names(target.value)


def _propagate(fn_node: ast.AST, tainted: Set[str]) -> Set[str]:
    """Two fixed passes of ``y = f(tainted)`` => ``y`` tainted (statement
    order, no joins — cheap and good enough for step-function bodies)."""
    for _ in range(2):
        for node in _body_nodes(fn_node):
            value = None
            targets = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            if value is None or not _mentions_taint(value, tainted):
                continue
            for t in targets:
                tainted.update(_bound_names(t))
    return tainted


@rule("RL005", "Python if/while on a tensor-typed name inside a hot root")
def check(project: Project) -> List[Finding]:
    graph = project.callgraph
    out: List[Finding] = []
    by_rel = {ctx.relpath: ctx for ctx in project.files.values()}
    for fn in graph.root_nodes():
        ctx = by_rel.get(fn.relpath)
        if ctx is None:
            continue
        tainted = set(fn.params()) - fn.static_params
        if not tainted:
            continue
        tainted = _propagate(fn.node, tainted)
        why = fn.root_reasons[0] if fn.root_reasons else "hot root"
        for node in _body_nodes(fn.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for name in _offending_names(node.test, tainted):
                out.append(ctx.finding(
                    "RL005", node,
                    f"branch on `{name.id}` in `{fn.qualname}` ({why}): "
                    f"Tensor.__bool__ waits for the device; use torch.where "
                    f"or declare it static"))
    return out
