"""Lightweight hot-path call graph over the linted files.

Port of ``repro/lint/callgraph.py``.  PyTorch runs eagerly, so there is no
``jit`` to find: a *hot root* is a function whose body runs on the device's
critical path, where a host read stalls the stream (and breaks CUDA-graph
capture).  Good enough for RL001/RL005, deliberately not a type checker:

* **Roots** are (a) the rows of :data:`HOT_ROOTS`, the port's counterparts
  of the reference graph's roots (its ``@partial(jax.jit, ...)`` wrappers,
  ``lax.scan`` / ``cond`` bodies, the jitted engine closures); (b)
  ``forward`` / ``backward`` of ``torch.autograd.Function`` subclasses and
  ``forward`` of ``nn.Module`` subclasses; (c) every def nested in a
  ``make_*_step`` factory — the reference's ``jax.jit(make_step(...))``
  idiom.
* **Edges** are name-based: a bare ``f(...)`` call resolves to any same-module
  function named ``f`` (including nested defs and methods); ``mod.f(...)``
  resolves through the file's ``import x as mod`` / ``from pkg import x as
  mod`` maps.  ``from pkg import f`` resolves bare ``f`` cross-module, and a
  name a package's ``__init__`` re-exports resolves to its definition.  A def nested in a reached
  function is reached too, whether it is called by name or handed on as a
  callback.
* **Static params**: a root's ``HOT_ROOTS`` row names them, and a parameter
  annotated with a non-tensor type (``bits: int``, ``c: Compressor``) is
  static, so RL005 doesn't taint config-style arguments.

Over-approximation (same-name functions merge) is fine — it only means a
function gets *checked*; it never hides one.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# (module, qualname, static params): the port's functions whose counterparts
# are roots of the reference's graph.  Loops the reference runs as a
# lax.scan / fori_loop body are Python loops here, so the function holding
# the loop is the root.  The Pallas kernel bodies (``_quant_kernel`` ...)
# have no Python counterpart: they are the CUDA kernels of kernels/csrc/.
HOT_ROOTS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    # src/repro/kernels/ops.py:31-162, @partial(jax.jit, static_argnames=...): their
    # static_argnames (less ``interpret``)
    ("repro_torch.kernels.ops", "pack_bits", ()),
    ("repro_torch.kernels.ops", "unpack_bits", ("d",)),
    ("repro_torch.kernels.ops", "quantize_pack", ("bits",)),
    ("repro_torch.kernels.ops", "stream_quantize_pack", ()),
    ("repro_torch.kernels.ops", "unpack_dequantize", ("d",)),
    ("repro_torch.kernels.ops", "quantize_dequantize", ("bits",)),
    ("repro_torch.kernels.ops", "prune_nm", ("n", "m")),
    ("repro_torch.kernels.ops", "prune_scored", ("mode", "sparsity")),
    # serve/engine.py _make_forward's jitted prefill_eff / decode_eff
    ("repro_torch.serve.engine", "DeltaServeEngine._slot_prefill", ()),
    ("repro_torch.serve.engine", "DeltaServeEngine._slot_decode", ()),
    # cohort/engine.py _make_cohort_sweep's jitted sweep (local, leaf_compress)
    ("repro_torch.cohort.engine", "CohortEngine._local_steps", ()),
    ("repro_torch.cohort.engine", "CohortEngine._leaf_compress.leaf_compress", ()),
    ("repro_torch.cohort.engine", "flix_local_step", ()),
    # core/distributed.py's lax.cond / lax.switch bodies
    ("repro_torch.core.distributed", "tree_param_sync", ()),
    ("repro_torch.core.distributed", "_tree_sync_fused", ()),
    ("repro_torch.core.distributed", "_tree_sync_leaves", ()),
    # lax.scan bodies of the paper's algorithms and of R^2-DSnoT
    ("repro_torch.core.ef_bv", "efbv_gd", ()),
    ("repro_torch.core.scafflix", "scafflix_run", ()),
    ("repro_torch.core.scafflix", "local_optimum", ()),
    ("repro_torch.core.scafflix", "flix_optimum", ()),
    ("repro_torch.core.symwanda", "r2_dsnot", ()),
    # models: the flash-attention scan bodies and the SSD associative scan
    ("repro_torch.models.attention", "_attend", ()),
    ("repro_torch.models.mamba", "_ssd_chunked", ()),
)

FACTORY_RE = re.compile(r"make_\w*_step")   # the jax.jit(make_step(...)) idiom
_FUNCTION_BASES = ("torch.autograd.Function", "autograd.Function")
_MODULE_BASES = ("torch.nn.Module", "nn.Module")


@dataclass
class FuncNode:
    module: str
    qualname: str           # "Class.method", "outer.inner" for nested defs
    relpath: str
    node: ast.AST           # FunctionDef | AsyncFunctionDef
    is_root: bool = False
    root_reasons: List[str] = field(default_factory=list)
    static_params: Set[str] = field(default_factory=set)
    calls: Set[str] = field(default_factory=set)        # bare local names
    attr_calls: Set[Tuple[str, str]] = field(default_factory=set)  # (alias, name)
    nested: List[str] = field(default_factory=list)     # qualnames of inner defs

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module, self.qualname)

    @property
    def bare(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return [n for n in names if n not in ("self", "cls")]

    def annotated_static(self) -> Set[str]:
        """Parameters annotated with a type that is not a tensor."""
        a = self.node.args
        return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                if p.annotation is not None
                and "Tensor" not in ast.unparse(p.annotation)}

    def mark_root(self, reason: str, static: Optional[Set[str]] = None):
        self.is_root = True
        if reason not in self.root_reasons:
            self.root_reasons.append(reason)
        if static:
            self.static_params |= static


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.manual_seed' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _ModuleScan(ast.NodeVisitor):
    """One pass over a file: functions, classes and import maps."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.stack: List[Tuple[str, str]] = []     # (name, "def" | "class")
        self.class_kind: List[Optional[str]] = []  # "function" | "module" | None
        self.nodes: Dict[str, FuncNode] = {}       # qualname -> node
        self.mod_aliases: Dict[str, str] = {}      # alias -> dotted module
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # name -> (mod, name)

    # -- imports ------------------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.mod_aliases[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and node.level == 0:
            for a in node.names:
                self.from_imports[a.asname or a.name] = (node.module, a.name)

    # -- classes and functions ----------------------------------------------
    def _base_kind(self, base: ast.AST) -> Optional[str]:
        d = dotted(base)
        if d is None:
            return None
        origin = self.from_imports.get(d)
        if origin is not None:
            d = ".".join(origin)
        if d in _FUNCTION_BASES or d.endswith(".autograd.Function"):
            return "function"
        if d in _MODULE_BASES or d.endswith(".nn.Module"):
            return "module"
        return None

    def visit_ClassDef(self, node: ast.ClassDef):
        kinds = {self._base_kind(b) for b in node.bases} - {None}
        self.class_kind.append(kinds.pop() if kinds else None)
        self.stack.append((node.name, "class"))
        self.generic_visit(node)
        self.stack.pop()
        self.class_kind.pop()

    def _handle_func(self, node):
        qual = ".".join([n for n, _ in self.stack] + [node.name])
        fn = FuncNode(self.ctx.module, qual, self.ctx.relpath, node)
        if self.stack and self.stack[-1][1] == "class":
            kind = self.class_kind[-1]
            if kind == "function" and node.name in ("forward", "backward"):
                fn.mark_root(f"autograd.Function.{node.name}", {"ctx"})
            elif kind == "module" and node.name == "forward":
                fn.mark_root("nn.Module.forward")
        factory = next((n for n, k in self.stack
                        if k == "def" and FACTORY_RE.fullmatch(n)), None)
        if factory is not None:
            fn.mark_root(f"nested in {factory}")
        if self.stack and self.stack[-1][1] == "def":
            self.nodes[".".join(n for n, _ in self.stack)].nested.append(qual)
        self.nodes[qual] = fn
        self.stack.append((node.name, "def"))
        self.class_kind.append(None)
        self.generic_visit(node)
        self.class_kind.pop()
        self.stack.pop()
        self._collect_calls(fn)

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    def _collect_calls(self, fn: FuncNode):
        """Call edges out of ``fn``'s own body, not descending into nested
        defs: those are their own nodes, reached with ``fn``."""
        stack = list(fn.node.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(sub))
            if isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Name):
                    fn.calls.add(sub.func.id)
                elif isinstance(sub.func, ast.Attribute) and \
                        isinstance(sub.func.value, ast.Name):
                    fn.attr_calls.add((sub.func.value.id, sub.func.attr))


@dataclass
class CallGraph:
    nodes: Dict[Tuple[str, str], FuncNode]
    by_bare: Dict[Tuple[str, str], List[Tuple[str, str]]]  # (mod, bare) -> keys
    mod_aliases: Dict[str, Dict[str, str]]                 # module -> alias map
    from_imports: Dict[str, Dict[str, Tuple[str, str]]]
    reachable: Set[Tuple[str, str]] = field(default_factory=set)

    @classmethod
    def build(cls, project) -> "CallGraph":
        nodes: Dict[Tuple[str, str], FuncNode] = {}
        by_bare: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        aliases: Dict[str, Dict[str, str]] = {}
        froms: Dict[str, Dict[str, Tuple[str, str]]] = {}
        for ctx in project.files.values():
            scan = _ModuleScan(ctx)
            scan.visit(ctx.tree)
            aliases[ctx.module] = scan.mod_aliases
            froms[ctx.module] = scan.from_imports
            for fn in scan.nodes.values():
                nodes[fn.key] = fn
                by_bare.setdefault((ctx.module, fn.bare), []).append(fn.key)

        graph = cls(nodes, by_bare, aliases, froms)
        for module, qual, static in HOT_ROOTS:
            fn = nodes.get((module, qual))
            if fn is not None:      # rows outside the linted paths stay unused
                fn.mark_root("HOT_ROOTS", set(static))
        for fn in nodes.values():
            if fn.is_root:
                fn.static_params |= fn.annotated_static()

        graph._compute_reachability()
        return graph

    def _defined(self, module: str, name: str, hops: int = 3
                 ) -> List[Tuple[str, str]]:
        """Functions ``name`` in ``module``, following a package's
        re-export (``from .x import name`` in ``__init__``) a few hops."""
        hits = self.by_bare.get((module, name))
        if hits:
            return list(hits)
        tgt = self.from_imports.get(module, {}).get(name)
        if tgt is None or hops == 0:
            return []
        return self._defined(tgt[0], tgt[1], hops - 1)

    def resolve(self, module: str, name: str) -> List[Tuple[str, str]]:
        """Function keys a bare name may refer to in ``module``."""
        hits = list(self.by_bare.get((module, name), []))
        tgt = self.from_imports.get(module, {}).get(name)
        if tgt is not None:
            hits += self._defined(*tgt)
        return hits

    def resolve_attr(self, module: str, alias: str, name: str
                     ) -> List[Tuple[str, str]]:
        mod = self.mod_aliases.get(module, {}).get(alias)
        if mod is None:
            tgt = self.from_imports.get(module, {}).get(alias)
            if tgt is None:
                return []
            mod = ".".join(tgt)
        return self._defined(mod, name)

    def _compute_reachability(self):
        work = [k for k, fn in self.nodes.items() if fn.is_root]
        seen = set(work)
        while work:
            key = work.pop()
            fn = self.nodes[key]
            targets = [(fn.module, q) for q in fn.nested]
            for name in fn.calls:
                targets += self.resolve(fn.module, name)
            for alias, name in fn.attr_calls:
                targets += self.resolve_attr(fn.module, alias, name)
            for t in targets:
                if t not in seen:
                    seen.add(t)
                    work.append(t)
        self.reachable = seen

    def reachable_nodes(self) -> List[FuncNode]:
        return [self.nodes[k] for k in sorted(self.reachable)]

    def root_nodes(self) -> List[FuncNode]:
        return [fn for fn in self.nodes.values() if fn.is_root]
