"""RL001 — host synchronization on the hot path.

Port of ``repro/lint/rules/rl001_host_sync.py``.  ``.item()``, ``.cpu()``,
``np.asarray`` (and friends) copy a device value to the host: PyTorch waits
for the stream to drain, silently, every step, and a CUDA graph cannot
capture the function at all.  The rule walks every function reachable from
a hot root (see ``repro_torch.lint.callgraph``) and flags:

* universal sins anywhere reachable: ``.item()``, ``.tolist()``, and the
  counterparts of ``jax.device_get`` — ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))`` —
  plus ``np.asarray`` / ``np.array`` / ``np.copy``;
* ``float(x)`` / ``int(x)`` / ``bool(x)`` on a tensor *parameter* — only in
  root functions (a non-root helper may legitimately coerce static config).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.callgraph import dotted
from repro_torch.lint.framework import Finding, Project, rule

_METHOD_SINS = {"item", "tolist", "cpu", "numpy"}
_NP_SINS = {"asarray", "array", "copy"}
_CAST_SINS = {"float", "int", "bool"}


def _numpy_aliases(graph, module: str) -> set:
    return {alias for alias, mod in graph.mod_aliases.get(module, {}).items()
            if mod == "numpy"}


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and dotted(node.func) in ("torch.device", "device")
            and bool(node.args) and _is_cpu(node.args[0]))


def _is_to_cpu(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    return (any(_is_cpu(a) for a in call.args[:1])
            or any(kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords))


def _body_nodes(fn_node: ast.AST):
    """Walk a function body without descending into nested defs (they are
    separate call-graph nodes and get scanned on their own)."""
    stack = [n for n in getattr(fn_node, "body", [])
             if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


@rule("RL001", "host sync (.item()/.cpu()/.numpy()/np.asarray/float(tensor)) "
               "reachable from a hot root")
def check(project: Project) -> List[Finding]:
    graph = project.callgraph
    out: List[Finding] = []
    by_rel = {ctx.relpath: ctx for ctx in project.files.values()}
    for fn in graph.reachable_nodes():
        ctx = by_rel.get(fn.relpath)
        if ctx is None:
            continue
        np_aliases = _numpy_aliases(graph, fn.module)
        tainted = (set(fn.params()) - fn.static_params) if fn.is_root else set()
        why = fn.root_reasons[0] if fn.root_reasons else "called from a hot root"
        for node in _body_nodes(fn.node):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _METHOD_SINS and not node.args:
                    out.append(ctx.finding(
                        "RL001", node,
                        f".{node.func.attr}() in `{fn.qualname}` ({why}): "
                        f"blocks on a device value on the hot path"))
                    continue
                if _is_to_cpu(node):
                    out.append(ctx.finding(
                        "RL001", node,
                        f".to('cpu') in `{fn.qualname}` ({why}): "
                        f"device->host transfer on the hot path"))
                    continue
                if (isinstance(node.func.value, ast.Name)
                        and node.func.value.id in np_aliases
                        and node.func.attr in _NP_SINS):
                    out.append(ctx.finding(
                        "RL001", node,
                        f"np.{node.func.attr}() in `{fn.qualname}` ({why}): "
                        f"materializes a tensor on the host"))
                    continue
            if (fn.is_root and isinstance(node.func, ast.Name)
                    and node.func.id in _CAST_SINS and len(node.args) == 1
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in tainted):
                out.append(ctx.finding(
                    "RL001", node,
                    f"{node.func.id}({node.args[0].id}) on a tensor argument "
                    f"of hot root `{fn.qualname}`: reads it back to the host"))
    return out
