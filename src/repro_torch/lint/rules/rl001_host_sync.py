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
* ``float(e)`` / ``int(e)`` / ``bool(e)`` of an expression ``e`` over a hot
  function's tensors: a tensor parameter (in a root, every parameter that is
  not static; elsewhere, one annotated as a tensor), any name assigned from
  such an expression in the function, and what operators, subscripts,
  ``torch.*`` functions and tensor methods make of them.  A tensor's
  metadata is not a tensor: ``x.shape``, ``x.ndim``, ``x.dtype``,
  ``x.size()``, ``x.numel()`` and their kin end the chain, so
  ``int(x.shape[0])`` is a Python int and not a finding.  A non-root
  helper's unannotated parameters are not seeds (it may legitimately coerce
  static config).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.lint.callgraph import dotted
from repro_torch.lint.framework import Finding, Project, rule

_METHOD_SINS = {"item", "tolist", "cpu", "numpy"}
_NP_SINS = {"asarray", "array", "copy"}
_CAST_SINS = {"float", "int", "bool"}
# tensor metadata: attributes and methods whose value is a Python object
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "layout",
               "itemsize", "nbytes", "is_leaf", "names", "grad_fn"}
_META_METHODS = {"size", "dim", "numel", "nelement", "element_size", "stride",
                 "data_ptr", "storage_offset", "get_device", "is_contiguous",
                 "is_floating_point", "is_complex", "untyped_storage"}
# torch functions of tensors whose value is not a tensor
_TORCH_META = {"torch.is_tensor", "torch.numel", "torch.is_floating_point",
               "torch.is_complex", "torch.finfo", "torch.iinfo", "torch.device",
               "torch.Size", "torch.promote_types", "torch.result_type"}


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


def _tensor_valued(node: ast.AST, tensors: set) -> bool:
    """Whether ``node`` evaluates to a tensor built from ``tensors`` (names)."""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Attribute):
        return node.attr not in _META_ATTRS and _tensor_valued(node.value, tensors)
    if isinstance(node, ast.Subscript):
        return _tensor_valued(node.value, tensors)
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        if name.startswith("torch."):
            return name not in _TORCH_META and any(
                _tensor_valued(a, tensors) for a in list(node.args)
                + [kw.value for kw in node.keywords])
        if isinstance(node.func, ast.Attribute):       # a method of a tensor
            return (node.func.attr not in _META_METHODS
                    and _tensor_valued(node.func.value, tensors))
        return False
    if isinstance(node, ast.BinOp):
        return _tensor_valued(node.left, tensors) or _tensor_valued(node.right, tensors)
    if isinstance(node, ast.UnaryOp):
        return _tensor_valued(node.operand, tensors)
    if isinstance(node, ast.Compare):
        return any(_tensor_valued(n, tensors) for n in [node.left] + node.comparators)
    if isinstance(node, ast.IfExp):
        return _tensor_valued(node.body, tensors) or _tensor_valued(node.orelse, tensors)
    return False


def _target_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _target_names(target.value)


def _tensor_names(fn, seeds: set) -> set:
    """``seeds`` and every name the function assigns from an expression over
    them (to a fixed point: assignments may come in any order in loops)."""
    tensors = set(seeds)
    assigns = [n for n in _body_nodes(fn.node)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
               and n.value is not None]
    while True:
        before = len(tensors)
        for n in assigns:
            if _tensor_valued(n.value, tensors):
                for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                    tensors.update(_target_names(t))
        if len(tensors) == before:
            return tensors


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
        seeds = (set(fn.params()) - fn.static_params) if fn.is_root else set()
        a = fn.node.args
        seeds |= {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                  if p.annotation is not None and "Tensor" in ast.unparse(p.annotation)}
        tensors = _tensor_names(fn, seeds)
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
            if (isinstance(node.func, ast.Name) and node.func.id in _CAST_SINS
                    and len(node.args) == 1 and _tensor_valued(node.args[0], tensors)):
                arg = ast.unparse(node.args[0])
                out.append(ctx.finding(
                    "RL001", node,
                    f"{node.func.id}({arg}) of a tensor in `{fn.qualname}` ({why}): "
                    f"reads it back to the host"))
    return out
