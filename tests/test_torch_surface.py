"""The port's public surface against the reference's, and the parity of the
pieces of that surface that no other test file holds.

The completeness guard reads both packages' sources with ``ast`` (it imports
neither package's modules):

(a) every ``src/repro/**/*.py`` has a module at the same relative path under
    ``src/repro_torch``, or an entry in ``COUNTERPART``;
(b) every name a reference module defines at its top level (def, class,
    assignment; private ones too) and every name a reference package's
    ``__init__`` exports is defined in, or imported into, the port's module
    under the same name; otherwise ``COUNTERPART`` names the port's symbol
    that does its work (and the symbol must exist), or ``JAX_ONLY`` says in
    one line why the port has none;
(c) every ``add_argument`` flag of a reference CLI module exists in the
    port's module, with the same ``choices`` where the reference gives them.

An entry of either table whose reference name is gone, or that the port now
defines under the reference's own name, fails the guard, and ``JAX_ONLY``
holds no name a reference package exports, so the tables cannot go stale.

Parity, on the CPU at reduced size, from the same seeded numpy inputs: the
tree algebra equals ``repro.utils.tree`` (sizes and bytes exact, the
elementwise maps bit for bit, ``tree_dot`` / ``tree_norm`` within rtol
1e-6: f32 sums in another order); ``attention_train`` equals the
reference's for every attention kind, with default and shifted positions,
within atol 2e-5 in f32 (the model tests' tolerance); ``layer_sizes`` is
exact.  ``launch.serve --dry-run`` hands over to the dry-run on the
(2, 16, 16) mesh.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.utils import tree as ttree

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
RTOL = 1e-6
ATTN_ATOL = 2e-5

# reference "module" or "module::name" -> the port's "module::symbol" doing
# its work under another name ("Class.member" for a member of a class)
COUNTERPART = {
    "configs/archs.py": "configs/base.py::_ensure_loaded",
    "cohort/engine.py::_make_cohort_sweep": "cohort/engine.py::CohortEngine.round",
    "core/distributed.py::fused_apply": "core/distributed.py::fused_apply_",
    "core/distributed.py::_fused_compress": "core/distributed.py::fused_compress_",
    "launch/costing.py::_lower_variant": "launch/costing.py::_trace_variant",
    "launch/dryrun.py::_abstract": "launch/dryrun.py::_meta_like",
    "launch/dryrun.py::_sharding": "launch/dryrun.py::distribute_tree",
    "launch/dryrun.py::build_train_lowering": "launch/dryrun.py::build_train_step",
    "launch/dryrun.py::build_prefill_lowering": "launch/dryrun.py::build_prefill_step",
    "launch/dryrun.py::build_decode_lowering": "launch/dryrun.py::build_decode_step",
    "launch/hlo_analysis.py::_crosses_pod": "launch/hlo_analysis.py::crosses_pod",
    "launch/hlo_analysis.py::_group_size": "launch/hlo_analysis.py::_group_ranks",
    "launch/mesh.py::ICI_BW": "launch/mesh.py::NVLINK_BW",
    "launch/perf.py::ICI_BW": "launch/perf.py::NVLINK_BW",
    "launch/perf.py::PEAK_FLOPS": "launch/perf.py::PEAK_FLOPS_BF16",
    "lint/contracts.py::KERNEL_VMEM_BUDGETS": "lint/contracts.py::KERNEL_SMEM_BUDGETS",
    "lint/contracts.py::VMEM_CEILING": "lint/contracts.py::SMEM_OPTIN_CEILING",
    "lint/contracts.py::_vmem_estimates": "lint/contracts.py::launch_table",
    "lint/contracts.py::_allowed_dtypes": "lint/contracts.py::check_compressor_grid",
    "lint/rules/rl001_host_sync.py::_is_device_get": "lint/rules/rl001_host_sync.py::_is_to_cpu",
    "models/transformer.py::_apply_block_train": "models/transformer.py::_apply_block",
    "models/transformer.py::_apply_block_decode": "models/transformer.py::decode_step",
    "models/transformer.py::_full_attention_nomask": "models/transformer.py::_full_attention",
    "models/transformer.py::_remat_wrap": "models/transformer.py::_trunk",
    "obs/trace.py::_jax_annotations": "obs/trace.py::_profiler_annotations",
    "obs/trace.py::_enter_jax_annotation": "obs/trace.py::_record_function",
    "serve/__init__.py::user_key": "serve/__init__.py::user_seed",
    "serve/deltas.py::user_key": "serve/deltas.py::user_seed",
    "serve/engine.py::_make_forward": "serve/engine.py::DeltaServeEngine._slot_prefill",
    "sharding/rules.py::_path_str": "sharding/rules.py::_map_with_path",
    "training/checkpoint.py::_flatten": "utils/tree.py::tree_flatten_with_path",
    "training/loop.py::log": "training/loop.py::_log",
}

_PALLAS = "a Pallas kernel body; the port's kernel is CUDA C++ in kernels/csrc/"
_HLO = "parses XLA's HLO text; the port counts the traced ops (CostCounter)"
_LINT_JAX = "a jax.jit / lax / Pallas idiom the JAX lint's call graph follows"
_ACTS = ("a with_sharding_constraint on the residual stream; a DTensor carries "
         "its placement (sharding.layout)")
JAX_ONLY = {
    "core/distributed.py::_level_key": "jax.random.fold_in per cascade level; the port "
                                       "takes draws as noise= or a torch.Generator",
    "kernels/bitpack.py::PACK_LANES": "the Pallas blocks' lane width",
    "kernels/bitpack.py::_pack_kernel": _PALLAS,
    "kernels/bitpack.py::_unpack_kernel": _PALLAS,
    "kernels/bitpack.py::_quant_pack_kernel": _PALLAS,
    "kernels/bitpack.py::_unpack_dequant_kernel": _PALLAS,
    "kernels/nm_prune.py::_nm_kernel": _PALLAS,
    "kernels/quant8.py::_quant_kernel": _PALLAS,
    "kernels/stream.py::N_SLOTS": "the Pallas DMA ring's VMEM slots",
    "kernels/stream.py::_stream_kernel": _PALLAS,
    "kernels/wanda_score.py::_score": _PALLAS,
    "kernels/wanda_score.py::_wanda_kernel": _PALLAS,
    "launch/hlo_analysis.py::_COLLECTIVES": _HLO,
    "launch/hlo_analysis.py::_DTYPE_BYTES": _HLO,
    "launch/hlo_analysis.py::_SHAPE_RE": _HLO,
    "launch/hlo_analysis.py::_shape_bytes": _HLO,
    "lint/callgraph.py::JIT_NAMES": _LINT_JAX,
    "lint/callgraph.py::LAX_TRACED": _LINT_JAX,
    "lint/callgraph.py::PALLAS_CALL": _LINT_JAX,
    "lint/callgraph.py::_static_from_call": _LINT_JAX,
    "models/transformer.py::UNROLL_SCAN": "unrolls lax.scan for XLA's cost analysis; "
                                          "the port's periods are a Python loop",
    "models/transformer.py::stack_scan": "lax.scan over the stacked periods; the port "
                                         "loops in Python",
    "models/transformer.py::_ACT_SPEC": _ACTS,
    "models/transformer.py::set_activation_sharding": _ACTS,
    "models/transformer.py::_constrain": _ACTS,
}


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _top_level(tree: ast.Module):
    """-> (defined, imported, members): names bound at a module's top level
    (into if / try / with bodies, not into functions), and each top-level
    class's member names."""
    defined, imported, members = set(), set(), {}

    def visit(stmts):
        for n in stmts:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defined.add(n.name)
            elif isinstance(n, ast.ClassDef):
                defined.add(n.name)
                members[n.name] = {m.name for m in n.body if isinstance(
                    m, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))} | {
                    e.id for m in n.body if isinstance(m, (ast.Assign, ast.AnnAssign))
                    for t in (m.targets if isinstance(m, ast.Assign) else [m.target])
                    for e in ast.walk(t) if isinstance(e, ast.Name)}
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for t in n.targets if isinstance(n, ast.Assign) else [n.target]:
                    defined.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
            elif isinstance(n, ast.Import):
                imported.update((a.asname or a.name).split(".")[0] for a in n.names)
            elif isinstance(n, ast.ImportFrom):
                imported.update(a.asname or a.name for a in n.names)
            elif isinstance(n, ast.If):
                visit(n.body)
                visit(n.orelse)
            elif isinstance(n, ast.Try):
                visit(n.body)
                for h in n.handlers:
                    visit(h.body)
                visit(n.orelse)
                visit(n.finalbody)
            elif isinstance(n, ast.With):
                visit(n.body)

    visit(tree.body)
    return defined, imported, members


def _dunder_all(tree: ast.Module) -> set:
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                             for t in n.targets):
            return set(ast.literal_eval(n.value))
    return set()


def _modules(pkg: Path) -> list:
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py"))


REF_MODULES = _modules(REF)


def _ref_surface(rel: str) -> set:
    """The names reference module ``rel`` defines (and, for a package's
    ``__init__``, exports), dunders left out."""
    tree = _parse(REF / rel)
    defined, imported, _ = _top_level(tree)
    names = set(defined)
    if rel.endswith("__init__.py"):
        names |= imported | _dunder_all(tree)
    return {n for n in names if not (n.startswith("__") and n.endswith("__"))}


def _port_names(rel: str) -> set:
    defined, imported, _ = _top_level(_parse(PORT / rel))
    return defined | imported


def _symbol_exists(target: str) -> bool:
    """``module::Name`` or ``module::Class.member`` in the port's source."""
    rel, _, sym = target.partition("::")
    if not (PORT / rel).exists():
        return False
    defined, imported, members = _top_level(_parse(PORT / rel))
    if not sym:
        return True
    head, _, member = sym.partition(".")
    if not member:
        return head in defined | imported
    return member in members.get(head, set())


def _exported_by_ref_packages() -> set:
    out = set()
    for rel in REF_MODULES:
        if rel.endswith("__init__.py"):
            tree = _parse(REF / rel)
            out |= _top_level(tree)[1] | _dunder_all(tree)
    return out


# --------------------------------------------------------------------------
# (a) modules, (b) names, (c) CLI flags
# --------------------------------------------------------------------------
def test_every_reference_module_has_a_port_module():
    missing = [rel for rel in REF_MODULES
               if not (PORT / rel).exists() and rel not in COUNTERPART]
    assert not missing, f"reference modules with no port module or COUNTERPART: {missing}"
    for rel in REF_MODULES:
        if rel in COUNTERPART:
            assert _symbol_exists(COUNTERPART[rel]), (rel, COUNTERPART[rel])


@pytest.mark.parametrize("rel", [r for r in REF_MODULES if (PORT / r).exists()])
def test_every_reference_name_has_a_port_name(rel):
    have = _port_names(rel)
    missing, bad = [], []
    for name in sorted(_ref_surface(rel)):
        key = f"{rel}::{name}"
        if name in have or key in JAX_ONLY:
            continue
        if key in COUNTERPART:
            if not _symbol_exists(COUNTERPART[key]):
                bad.append((key, COUNTERPART[key]))
            continue
        missing.append(name)
    assert not missing, f"{rel}: names the port lacks (port them, or enter them in " \
                        f"COUNTERPART or JAX_ONLY): {missing}"
    assert not bad, f"{rel}: COUNTERPART symbols that do not exist: {bad}"


def _cli_flags(path: Path) -> dict:
    """{flag: choices or None} of every ``add_argument`` call in ``path``."""
    out = {}
    for n in ast.walk(_parse(path)):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "add_argument":
            choices = next((list(ast.literal_eval(k.value)) for k in n.keywords
                            if k.arg == "choices"), None)
            for a in n.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out[a.value] = choices
    return out


CLI_MODULES = [r for r in REF_MODULES if _cli_flags(REF / r)]


@pytest.mark.parametrize("rel", CLI_MODULES)
def test_every_reference_cli_flag_exists_in_the_port(rel):
    want, have = _cli_flags(REF / rel), _cli_flags(PORT / rel)
    missing = sorted(set(want) - set(have))
    assert not missing, f"{rel}: flags the port lacks: {missing}"
    for flag, choices in want.items():
        if choices is not None:
            assert have[flag] == choices, (rel, flag, choices, have[flag])


def test_the_guard_sees_the_surface():
    """The walkers find what they should: the reference's CLIs, a few hundred
    names, and the tree algebra among the names ``repro.utils`` exports."""
    assert set(CLI_MODULES) >= {"launch/serve.py", "launch/train.py", "launch/dryrun.py",
                                "launch/perf.py", "lint/__main__.py", "obs/report.py"}
    assert sum(len(_ref_surface(r)) for r in REF_MODULES) > 500
    assert {"tree_dot", "tree_norm", "global_norm", "tree_map"} <= _ref_surface(
        "utils/__init__.py")
    assert _cli_flags(REF / "launch/serve.py")["--shape"] == ["prefill_32k", "decode_32k",
                                                             "long_500k"]


@pytest.mark.parametrize("table", ["COUNTERPART", "JAX_ONLY"])
def test_the_tables_are_not_stale(table):
    """Every entry names a reference name that exists and that the port does
    not define under that same name; every JAX_ONLY entry has a reason and
    is no name a reference package exports (those are the surface users
    import)."""
    entries = COUNTERPART if table == "COUNTERPART" else JAX_ONLY
    exported = _exported_by_ref_packages()
    for key, value in entries.items():
        rel, _, name = key.partition("::")
        assert (REF / rel).exists(), f"{table}: {key}: no reference module {rel}"
        if not name:
            assert not (PORT / rel).exists(), f"{table}: {key}: the port has {rel} now"
            continue
        assert name in _ref_surface(rel), f"{table}: {key}: the reference has no {name}"
        assert name not in _port_names(rel), f"{table}: {key}: the port has {name} now"
        if table == "JAX_ONLY":
            assert value.strip(), f"JAX_ONLY: {key} has no reason"
            assert name not in exported, f"JAX_ONLY: {key} is exported by a reference package"


def test_the_reference_packages_imports_work_against_the_port():
    """The imports a user of the reference writes, against the port, in a
    fresh process that then holds no ``jax`` and no ``repro``."""
    code = """
import sys
from repro_torch.training import (train, make_train_step, init_train_state, TrainState,
                                  make_prefill_step, make_decode_step, save_checkpoint,
                                  load_checkpoint)
from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.comm import (crosscheck_hlo, norm_ppf, pipelined_time_s, ring_parts_s,
                              ring_time_s, straggler_level_time_s, stream_pipeline_s)
from repro_torch.utils import (tree_size, tree_bytes, tree_zeros_like, tree_add, tree_sub,
                               tree_scale, tree_dot, tree_norm, global_norm, tree_map)
from repro_torch.core.fedp3 import layer_sizes
from repro_torch.models.attention import attention_train
import repro_torch.core as core
for m in ("compressors", "distributed", "ef_bv", "fedp3", "scafflix", "sppm", "symwanda"):
    assert getattr(core, m).__name__ == "repro_torch.core." + m
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro.utils import tree as jtree
    return jax, jnp, jattn, jtree


def _numpy_tree(seed):
    """Nested dicts and lists, f32 and bf16 leaves (bf16 as a dtype name)."""
    rng = np.random.default_rng(seed)
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": (leaf(5, 3), "float32"),
            "blocks": [(leaf(4), "bfloat16"),
                       {"a": (leaf(2, 2, 2), "float32"), "b": [(leaf(7), "bfloat16")]}],
            "mixed": (leaf(6), "bfloat16" if seed % 2 else "float32")}


def _is_leaf(t):
    return isinstance(t, tuple) and isinstance(t[1], str)


def _build(tree, make):
    if _is_leaf(tree):
        return make(*tree)
    if isinstance(tree, dict):
        return {k: _build(v, make) for k, v in tree.items()}
    return [_build(v, make) for v in tree]


def _both(jx, seed):
    jax, jnp = jx[0], jx[1]
    nt = _numpy_tree(seed)
    j = _build(nt, lambda a, dt: jnp.asarray(a, dtype=getattr(jnp, dt)))
    t = _build(nt, lambda a, dt: torch.from_numpy(a).to(getattr(torch, dt)))
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(np.float32))


def _leaves_equal(jx, jt, tt):
    jax = jx[0]
    jl, tl = jax.tree_util.tree_leaves(jt), ttree.tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), (a.dtype, b.dtype)
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float32), _np(b))


def test_tree_sizes_and_bytes_exact(jx):
    jtree = jx[3]
    j, t = _both(jx, 1)
    assert ttree.tree_size(t) == jtree.tree_size(j) == 5 * 3 + 4 + 8 + 7 + 6
    assert ttree.tree_bytes(t) == jtree.tree_bytes(j)


def test_tree_maps_bit_for_bit(jx):
    """zeros_like, add, sub (a bf16 leaf against an f32 one promotes to f32
    in both) and scale by a Python float (keeps each leaf's dtype in both)."""
    jtree = jx[3]
    ja, ta = _both(jx, 1)
    jb, tb = _both(jx, 2)
    _leaves_equal(jx, jtree.tree_zeros_like(ja), ttree.tree_zeros_like(ta))
    _leaves_equal(jx, jtree.tree_add(ja, jb), ttree.tree_add(ta, tb))
    _leaves_equal(jx, jtree.tree_sub(ja, jb), ttree.tree_sub(ta, tb))
    _leaves_equal(jx, jtree.tree_scale(0.37, ja), ttree.tree_scale(0.37, ta))
    _leaves_equal(jx, jtree.tree_map(lambda x: x * 2, ja), ttree.tree_map(lambda x: x * 2, ta))


@pytest.mark.parametrize("slice_elems", [None, 3])
def test_tree_dot_and_norm_within_rtol(jx, slice_elems):
    """0-d f32 tensors on the leaves' device; the sliced sums (a leaf wider
    than ``slice_elems`` taken a few rows at a time) within the same rtol."""
    jtree = jx[3]
    ja, ta = _both(jx, 1)
    jb, tb = _both(jx, 2)
    kw = {} if slice_elems is None else {"slice_elems": slice_elems}
    got = {"dot": ttree.tree_dot(ta, tb, **kw), "norm": ttree.tree_norm(ta, **kw),
           "global": ttree.global_norm(ta)}
    want = {"dot": jtree.tree_dot(ja, jb), "norm": jtree.tree_norm(ja),
            "global": jtree.global_norm(ja)}
    for k, g in got.items():
        assert g.dim() == 0 and g.dtype == torch.float32 and g.device.type == "cpu", k
        w = float(want[k])
        assert abs(float(g) - w) <= RTOL * abs(w), (k, float(g), w)


def test_the_optimizer_grad_norm_is_the_tree_norm():
    """One implementation: ``optim``'s grad norm is ``utils.tree.tree_norm``
    in the optimizer's slices, bit for bit."""
    from repro_torch.optim import optimizers as topt
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
            "b": [torch.from_numpy(rng.standard_normal(9).astype(np.float32)).bfloat16()]}
    assert torch.equal(topt.tree_norm(tree), ttree.tree_norm(tree))
    assert topt.clip_by_global_norm(tree, 1.0)[1].item() == ttree.tree_norm(tree).item()


def test_layer_sizes_exact(jx):
    from repro.core.fedp3 import layer_sizes as jsizes
    from repro_torch.core.fedp3 import layer_sizes
    jnp = jx[1]
    sizes = (32, 16, 16, 10)
    shapes = [((a, b), (b,)) for a, b in zip(sizes[:-1], sizes[1:])]
    jl = [{"W": jnp.zeros(w), "b": jnp.zeros(b)} for w, b in shapes]
    tl = [{"W": torch.zeros(w), "b": torch.zeros(b)} for w, b in shapes]
    assert layer_sizes(tl) == jsizes(jl) == [32 * 16 + 16, 16 * 16 + 16, 16 * 10 + 10]


ATTN_KINDS = [("attn", 0, 0), ("attn_swa", 8, 0), ("attn_chunk", 0, 16), ("full", 0, 0)]


@pytest.mark.parametrize("shift", [None, 7])
@pytest.mark.parametrize("kind,window,chunk", ATTN_KINDS)
def test_attention_train_matches_jax(jx, monkeypatch, kind, window, chunk, shift):
    """(B, S) = (2, 40) through 16 x 16 tiles (ragged), GQA 4 / 2 heads,
    RoPE; the global kind also with QKV bias and qk-norm."""
    jax, jnp, jattn = jx[0], jx[1], jx[2]
    from repro_torch.models import attention as tattn
    for m in (jattn, tattn):
        monkeypatch.setattr(m, "BLOCK_Q", 16)
        monkeypatch.setattr(m, "BLOCK_K", 16)
    B, S, D, H, KV, HD = 2, 40, 32, 4, 2, 8
    rng = np.random.default_rng(11)
    w = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    params = {"wq": w(D, H * HD), "wk": w(D, KV * HD), "wv": w(D, KV * HD),
              "wo": w(H * HD, D)}
    bias = kind == "attn"
    if bias:
        params.update(bq=w(H * HD), bk=w(KV * HD), bv=w(KV * HD))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cfg = {"num_heads": H, "num_kv_heads": KV, "head_dim": HD, "kind": kind,
           "window": window, "chunk": chunk, "qk_norm": bias, "use_rope": True,
           "rope_theta": 10000.0}
    pos = None if shift is None else np.arange(shift, shift + S)[None, :]
    want = jattn.attention_train({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(x), cfg_attn=cfg,
                                 positions=None if pos is None else jnp.asarray(pos))
    got = tattn.attention_train({k: torch.from_numpy(v) for k, v in params.items()},
                                torch.from_numpy(x), cfg_attn=cfg,
                                positions=None if pos is None else torch.from_numpy(pos))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)
    if shift is None:
        out, cache = tattn.attention_prefill(
            {k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x),
            cfg_attn=cfg)
        assert torch.equal(out, got) and cache["k"].shape == (B, S, KV, HD)


def test_serve_cli_hands_the_dry_run_over_on_the_multi_pod_mesh(tmp_path):
    """``launch.serve --dry-run --multi-pod`` execs ``launch.dryrun`` with
    the serving shape and the (2, 16, 16) mesh: full-width mamba2-2.7b at
    ``decode_32k`` on rank 0 of a 512-rank fake group."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "mamba2-2.7b", "--dry-run", "--shape", "decode_32k", "--multi-pod"],
                       capture_output=True, text=True, env=env, cwd=str(tmp_path),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "results" / "dryrun"
                      / "mamba2-2.7b__decode_32k__mp__dense.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["shape"] == "decode_32k"
    assert rec["memory"]["argument_size_in_bytes"] > 0 and sum(rec["collectives"].values()) > 0
