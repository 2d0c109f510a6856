"""Engine 2 — contract checks (port of ``repro/lint/contracts.py``).

Three contract families, reported as RC-rule findings, each on a ``device``:

* **RC001 codec fidelity** — every compressor in ``core.compressors._REGISTRY``
  is instantiated from :data:`CONTRACT_PARAMS` and run over
  :data:`SHAPE_GRID` x :data:`DTYPE_GRID` on the ``meta`` device (shapes and
  dtypes only, no data), stochastic ones given a ``noise=`` of the shape they
  draw.  A compressor that launches a kernel (:data:`ON_DEVICE`) has no meta
  version and runs on ``device`` at the same shapes.  The carrier must keep
  the input shape, and its dtype must be the input dtype or float32.

* **RC002 payload accounting** — a small *concrete* probe per compressor at
  d = 1000 on ``device``, its draws from a seeded generator:
  ``decode(encode(x)) == c(x)`` elementwise, the declared plane bytes sum to
  ``payload.nbytes``, and ``codecs.extrapolate_bits(p, d, d)`` equals
  ``p.nbits`` exactly.  On the card ``qsgd_kernel`` runs B1 (the carrier),
  B2 (encode) and B3 (decode).

* **RC003 kernel resources** — the CUDA kernels' launch resources.  The
  static half (any device) reads each ``kernels/csrc/*.cu`` file's integer
  ``constexpr`` launch constants from its text (:func:`cu_constants`; no
  Python copy of them is kept) and checks threads per block and dynamic
  shared memory against the kernel's :data:`KERNEL_SMEM_BUDGETS` row and
  the sm_90a opt-in ceiling, the selecting B8's staging at
  :data:`B8_STAGED`, ``PACK_BITS <= 32``, the wire-spec arithmetic, and
  the shape/dtype algebra of the ``kernels.ops`` wrappers on small CPU
  tensors.  The card half (a CUDA ``device``) asks the built library: for
  every ``__global__`` (each template instance) the launch's threads,
  dynamic shared memory and cluster size, ``cudaFuncGetAttributes`` and
  the occupancy (blocks per SM, or clusters on the device for the
  selecting B8, at a staged and an unstaged ``d_in``).  A launch that
  differs from what the source's constants give, threads above
  ``maxThreadsPerBlock``, static + dynamic shared memory over budget, the
  selecting B8 staged otherwise than designed, zero occupancy, or local
  memory the budget row does not allow is a finding.

Run via ``python -m repro_torch.lint`` (on by default; ``--no-contracts``
skips) or directly: ``run_contracts(device) -> list[Finding]``.
"""
from __future__ import annotations

import ast
import math
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.lint.framework import Finding

# Every _REGISTRY entry needs a row here — several factories have required
# kwargs (k_frac etc.) with no defaults.  test_torch_lint asserts the coverage.
CONTRACT_PARAMS: Dict[str, dict] = {
    "identity": {},
    "rand_k": {"k_frac": 0.25},
    "top_k": {"k_frac": 0.25},
    "topk_block": {"k_frac": 0.25, "block": 256},
    "qsgd": {"bits": 8, "block": 256},
    "qsgd_sharded": {"bits": 8, "block": 64},
    "qsgd_kernel": {"bits": 8},
    "mix_k": {"k_frac_top": 0.25, "k_frac_rand": 0.25},
    "comp_k": {"k_frac_top": 0.1, "k_frac_rand": 0.5},
}

SHAPE_GRID = ((64,), (257,), (4096,), (8, 512))
DTYPE_GRID = (torch.float32, torch.bfloat16)
# compressors whose carrier launches a kernel (B1): the kernel wrappers take
# CPU or CUDA tensors, never meta ones
ON_DEVICE = ("qsgd_kernel",)

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
# sm_90a: shared memory a block may opt into (227 KB) and threads per block
SMEM_OPTIN_CEILING = 232_448
MAX_THREADS = 1024
# the selecting B8's d_in and whether it is designed to stage its keys:
# h2o-danube-1.8b's w_in (staged) and qwen1.5-110b's (too tall to stage)
B8_STAGED = {2560: True, 8192: False}


class Budget(NamedTuple):
    """Static + dynamic shared memory a kernel may hold per block, and the
    local (stack / spill) bytes it may use, with the reason."""
    smem: int
    local: int = 0
    why: str = ""


# Deliberately tight: a kernel that gains a shared array, or a ring that
# doubles, fails here before anyone reads its occupancy.
KERNEL_SMEM_BUDGETS: Dict[str, Budget] = {
    "quant_dequant_2d": Budget(1024),
    "quant_pack_2d": Budget(1024),
    "unpack_dequant_2d": Budget(1024),
    "pack_mask_2d": Budget(1024),
    "unpack_mask_2d": Budget(1024),
    "stream_quant_pack_2d": Budget(1 << 17),
    "nm_prune_2d": Budget(1024),
    "delta_apply": Budget(1024),
    # the selecting launch stages a strip's keys up to the opt-in limit by
    # design (csrc/prune.cu, selecting_smem)
    "wanda_prune_2d": Budget(
        SMEM_OPTIN_CEILING, 32,
        "the bf16 ria selecting instance keeps a 32 B stack frame (ptxas: 28 B "
        "of spill stores) under __launch_bounds__(256): its 8 gathered keys, "
        "8 columns' statistics and two divisions a score fill the registers"),
}


class Launch(NamedTuple):
    """One kernel instance as its C entry launches it, from the source's
    constants."""
    kid: str            # B1 ... B8, D1
    wrapper: str        # the kernel's Python wrapper (KERNEL_SMEM_BUDGETS key)
    source: str         # csrc file
    index: int          # the instance's index in the file's resource report
    name: str           # the instance's name in the report
    threads: int
    smem: int           # dynamic shared memory per block
    cluster: int
    staged: bool
    d_in: int           # rows of a selecting B8 launch, else 0


def _finding(rule: str, path: str, message: str) -> Finding:
    return Finding(rule, path, 1, 1, message, snippet=f"<{rule} contract>")


def _error(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
# RC001 — compressor shape/dtype fidelity
# ---------------------------------------------------------------------------
def _noise(name: str, c, shape: tuple, device: torch.device, gen: torch.Generator):
    """The uniform draws compressor ``name`` takes for an input of ``shape``
    (``core/compressors.py``'s table), or None for a deterministic one."""
    from repro_torch.kernels.ops import tile_rows

    d = math.prod(shape)
    spec = c.wire

    def u(*s):
        return torch.rand(s, generator=gen, device=gen.device).to(device)

    if name in ("identity", "top_k", "topk_block"):
        return None
    if name in ("rand_k", "comp_k"):
        return u(d)
    if name == "mix_k":
        return (u(), u(d))
    if name == "qsgd":
        return u(-(-d // spec.block), spec.block) - 0.5
    if name == "qsgd_sharded":
        last = shape[-1]
        return u(*(shape[:-1] + (last // spec.block, spec.block)
                   if last % spec.block == 0 else shape))
    if name == "qsgd_kernel":
        return u(tile_rows(d), spec.block)
    raise KeyError(f"no noise shape for compressor {name!r}")


def check_compressor_grid(device) -> List[Finding]:
    from repro_torch.core.compressors import _REGISTRY, make_compressor

    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    path = "src/repro_torch/core/compressors.py"
    out: List[Finding] = []
    for name in sorted(_REGISTRY):
        if name not in CONTRACT_PARAMS:
            out.append(_finding(
                "RC001", path,
                f"compressor {name!r} has no CONTRACT_PARAMS row — the "
                f"shape grid does not cover it"))
            continue
        c = make_compressor(name, **CONTRACT_PARAMS[name])
        where = device if name in ON_DEVICE else torch.device("meta")
        for shape in SHAPE_GRID:
            for dtype in DTYPE_GRID:
                x = (torch.empty(shape, dtype=dtype, device=where) if where.type == "meta"
                     else torch.randn(shape, generator=gen).to(where, dtype))
                try:
                    y = c(x, noise=_noise(name, c, shape, where, gen))
                except Exception as e:  # noqa: BLE001 — report, don't crash
                    out.append(_finding(
                        "RC001", path,
                        f"{name} fails on {shape} {dtype} ({where.type}): {_error(e)}"))
                    continue
                if tuple(y.shape) != tuple(shape):
                    out.append(_finding(
                        "RC001", path,
                        f"{name} on {shape} {dtype}: carrier shape "
                        f"{tuple(y.shape)} != input shape"))
                if y.dtype not in (dtype, torch.float32):
                    out.append(_finding(
                        "RC001", path,
                        f"{name} on {shape} {dtype}: carrier dtype {y.dtype} "
                        f"not in {{input, float32}}"))
    for name in sorted(set(CONTRACT_PARAMS) - set(_REGISTRY)):
        out.append(_finding(
            "RC001", path,
            f"CONTRACT_PARAMS row {name!r} matches no registered compressor"))
    return out


# ---------------------------------------------------------------------------
# RC002 — wire payload vs accounting byte formulas
# ---------------------------------------------------------------------------
def check_payload_accounting(device) -> List[Finding]:
    from repro_torch.comm import codecs
    from repro_torch.core.compressors import _REGISTRY, make_compressor
    from repro_torch.utils.device import make_generator

    device = torch.device(device)
    path = "src/repro_torch/comm/codecs.py"
    out: List[Finding] = []
    d = 1000  # not a block multiple: stresses pad/trim on every scheme
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(device)
    for name in sorted(set(_REGISTRY) & set(CONTRACT_PARAMS)):
        c = make_compressor(name, **CONTRACT_PARAMS[name])
        try:
            p = codecs.encode(c, x, generator=make_generator(0, device))
            y = codecs.decode(p, device=device)
            same = codecs.roundtrip_equal(c, x, seed=0)
        except Exception as e:  # noqa: BLE001 — report, don't crash
            out.append(_finding(
                "RC002", path, f"{name}: encode/decode raised {_error(e)}"))
            continue
        if tuple(y.shape) != (d,):
            out.append(_finding(
                "RC002", path,
                f"{name}: decoded shape {tuple(y.shape)} != ({d},)"))
        if not same:
            out.append(_finding(
                "RC002", path,
                f"{name}: decode(encode(x)) != compressor carrier "
                f"(scheme {p.scheme})"))
        plane_bytes = sum(v.nbytes for v in p.planes.values())
        if plane_bytes != p.nbytes:
            out.append(_finding(
                "RC002", path,
                f"{name}: declared payload nbytes {p.nbytes} != plane sum "
                f"{plane_bytes}"))
        extr = codecs.extrapolate_bits(p, d, d)
        if extr != p.nbits:
            out.append(_finding(
                "RC002", path,
                f"{name}: extrapolate_bits(p, {d}, {d}) = {extr} != exact "
                f"nbits {p.nbits} — accounting formula diverges from the "
                f"wire planes at the probe size itself"))
    return out


# ---------------------------------------------------------------------------
# RC003 — kernel launch resources
# ---------------------------------------------------------------------------
_CONSTEXPR = re.compile(
    r"^\s*constexpr\s+(?:unsigned\s+)?(?:int|int64_t|size_t)\s+(k\w+)\s*=\s*([^;]+);",
    re.M)
_ARITH = re.compile(r"(?:\s|[-+*/()]|\d+|k\w+)+")


def _c_int(node: ast.AST, env: Dict[str, int]) -> int:
    """A C integer expression of decimal literals, earlier constants,
    ``+ - * /`` (C's truncating division) and parentheses."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_c_int(node.operand, env)
    if isinstance(node, ast.BinOp):
        a, b = _c_int(node.left, env), _c_int(node.right, env)
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, ast.Div):
            q = abs(a) // abs(b)
            return q if (a < 0) == (b < 0) else -q
    raise ValueError(f"not a C integer expression: {ast.unparse(node)}")


def cu_constants(source: str) -> Dict[str, int]:
    """The integer ``constexpr`` constants of ``kernels/csrc/<source>``, as
    the compiler folds them: each over the ones before it.  A constant of
    another form (a hex or suffixed literal, a cast) is left out."""
    out: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall((CSRC / source).read_text()):
        if _ARITH.fullmatch(expr):
            out[name] = _c_int(ast.parse(expr.strip(), mode="eval").body, out)
    return out


def launch_table(optin: int = SMEM_OPTIN_CEILING) -> List[Launch]:
    """Every kernel instance with its launch as the ``.cu`` files' constants
    give it, the selecting B8 at each d_in of ``B8_STAGED`` on a device of
    opt-in limit ``optin`` (``selecting_smem`` in csrc/prune.cu: the head,
    plus the strip's keys when they fit)."""
    from repro_torch.kernels import wanda_score as ws

    quant, mask, prune, delta = (cu_constants(s) for s in
                                 ("quant.cu", "bitmask.cu", "prune.cu", "delta.cu"))
    rows = [
        Launch("B1", "quant_dequant_2d", "quant.cu", 0, "quant_kernel<false>",
               quant["kThreads"], 0, 1, False, 0),
        Launch("B2", "quant_pack_2d", "quant.cu", 1, "quant_kernel<true>",
               quant["kThreads"], 0, 1, False, 0),
        Launch("B3", "unpack_dequant_2d", "quant.cu", 2, "unpack_dequant_kernel",
               quant["kThreads"], 0, 1, False, 0),
        Launch("B6", "stream_quant_pack_2d", "quant.cu", 3, "stream_quant_pack_kernel",
               quant["kThreads"], quant["kStreamSmem"], 1, False, 0),
        Launch("B4", "pack_mask_2d", "bitmask.cu", 0, "pack_mask_kernel",
               mask["kThreads"], 0, 1, False, 0),
        Launch("B5", "unpack_mask_2d", "bitmask.cu", 1, "unpack_mask_kernel",
               mask["kThreads"], 0, 1, False, 0),
        Launch("B7", "nm_prune_2d", "prune.cu", 0, "nm_prune_kernel<float>",
               prune["kThreads"], 0, 1, False, 0),
        Launch("B7", "nm_prune_2d", "prune.cu", 1, "nm_prune_kernel<bf16>",
               prune["kThreads"], 0, 1, False, 0),
        Launch("D1", "delta_apply", "delta.cu", 0, "delta_apply_kernel",
               delta["kThreads"], 0, 1, False, 0),
    ]
    head, per_row = prune["kSelectHeadSmem"], prune["kStagedRowSmem"]
    for t, tname in enumerate(("float", "bf16")):
        for mode, mname in enumerate(ws.MODES):
            for select in (False, True):
                index = 2 + (t * 3 + mode) * 2 + select
                name = (f"wanda_prune_kernel<{tname},{mname},"
                        f"{'select' if select else 'given'}>")
                if not select:
                    rows.append(Launch("B8", "wanda_prune_2d", "prune.cu", index, name,
                                       prune["kThreads"], 0, 1, False, 0))
                    continue
                for d_in in B8_STAGED:
                    smem = head + per_row * d_in
                    staged = smem <= optin
                    rows.append(Launch("B8", "wanda_prune_2d", "prune.cu", index, name,
                                       prune["kThreads"], smem if staged else head,
                                       prune["kCluster"], staged, d_in))
    return rows


def _kernel_path(source: str) -> str:
    return f"src/repro_torch/kernels/csrc/{source}"


def _launch_label(row: Launch) -> str:
    at = f" at d_in {row.d_in}" if row.d_in else ""
    return f"{row.kid} {row.name}{at}"


def _check_static_launches() -> List[Finding]:
    out: List[Finding] = []
    for row in launch_table():
        path, label = _kernel_path(row.source), _launch_label(row)
        budget = KERNEL_SMEM_BUDGETS[row.wrapper]
        if row.threads > MAX_THREADS or row.threads % 32:
            out.append(_finding(
                "RC003", path,
                f"{label}: {row.threads} threads per block, not a whole number "
                f"of warps up to {MAX_THREADS}"))
        if row.smem > budget.smem:
            out.append(_finding(
                "RC003", path,
                f"{label}: {row.smem} B of dynamic shared memory exceeds its "
                f"budget {budget.smem} B"))
        if row.smem > SMEM_OPTIN_CEILING:
            out.append(_finding(
                "RC003", path,
                f"{label}: {row.smem} B of dynamic shared memory exceeds the "
                f"sm_90a opt-in ceiling {SMEM_OPTIN_CEILING} B"))
        if row.d_in and row.staged != B8_STAGED[row.d_in]:
            out.append(_finding(
                "RC003", path,
                f"{label}: staged={row.staged}, designed "
                f"staged={B8_STAGED[row.d_in]}"))
    return out


def kernel_resources(device) -> List[dict]:
    """The card half's measurements: for every row of :func:`launch_table` (at
    the device's opt-in limit) the library's report, its fields as in
    ``build.RESOURCE_FIELDS`` beside the row, as ``launch``."""
    from repro_torch.kernels import build

    device = torch.device(device)
    optin = build.resources(build.RESOURCE_ENTRIES["quant.cu"], 0, device)["optin"]
    out = []
    for row in launch_table(optin):
        got = build.resources(build.RESOURCE_ENTRIES[row.source], row.index, device,
                              row.d_in)
        out.append({**got, "launch": row})
    return out


def check_kernel_resources(device) -> List[Finding]:
    """RC003's card half on CUDA ``device``.  A failed query raises."""
    out: List[Finding] = []
    rows = kernel_resources(device)
    for r in rows:
        row: Launch = r["launch"]
        path, label = _kernel_path(row.source), _launch_label(row)
        budget = KERNEL_SMEM_BUDGETS[row.wrapper]
        n_kernels = len({r2["launch"].index for r2 in rows
                         if r2["launch"].source == row.source})
        want = {"name": row.name, "count": n_kernels,
                "threads": row.threads, "dyn_smem": row.smem, "cluster": row.cluster,
                "staged": int(row.staged)}
        for key, value in want.items():
            if r[key] != value:
                out.append(_finding(
                    "RC003", path,
                    f"{label}: the library's {key} is {r[key]!r}, the source's "
                    f"constants give {value!r}"))
        if r["threads"] > r["max_threads"]:
            out.append(_finding(
                "RC003", path,
                f"{label}: {r['threads']} threads per block > maxThreadsPerBlock "
                f"{r['max_threads']} ({r['regs']} registers a thread)"))
        smem = r["static_smem"] + r["dyn_smem"]
        if smem > budget.smem:
            out.append(_finding(
                "RC003", path,
                f"{label}: {r['static_smem']} B static + {r['dyn_smem']} B dynamic "
                f"shared memory exceeds its budget {budget.smem} B"))
        if row.d_in and bool(r["staged"]) != B8_STAGED[row.d_in]:
            out.append(_finding(
                "RC003", path,
                f"{label}: the library staged={bool(r['staged'])}, designed "
                f"staged={B8_STAGED[row.d_in]}"))
        if r["occupancy"] < 1:
            out.append(_finding(
                "RC003", path,
                f"{label}: occupancy 0 — the launch cannot be resident"))
        if r["local"] > budget.local:
            out.append(_finding(
                "RC003", path,
                f"{label}: {r['local']} B of local memory (spills or stack), "
                f"its budget allows {budget.local} B"))
    return out


def check_kernel_budgets(device) -> List[Finding]:
    from repro_torch.comm.codecs import _PACK_MAX_NBITS
    from repro_torch.core.compressors import _REGISTRY, make_compressor
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant8 as q8

    out: List[Finding] = _check_static_launches()
    kpath = "src/repro_torch/kernels"

    # --- bitpack word-width overflow
    if bp.PACK_BITS > 32:
        out.append(_finding(
            "RC003", f"{kpath}/bitpack.py",
            f"PACK_BITS={bp.PACK_BITS} > 32: mask words no longer fit uint32"))

    # --- wire-spec arithmetic of every registered compressor
    for name in sorted(set(_REGISTRY) & set(CONTRACT_PARAMS)):
        spec = make_compressor(name, **CONTRACT_PARAMS[name]).wire
        if spec is None:
            continue
        if spec.scheme == "sparse_block":
            nbits = max(1, math.ceil(math.log2(spec.block)))
            if nbits > 32:
                out.append(_finding(
                    "RC003", "src/repro_torch/comm/codecs.py",
                    f"{name}: sparse_block offsets need {nbits} bits "
                    f"(block={spec.block}) > 32 — index plane overflows"))
            if nbits > _PACK_MAX_NBITS:
                out.append(_finding(
                    "RC003", "src/repro_torch/comm/codecs.py",
                    f"{name}: {nbits}-bit offsets exceed the uint-stream "
                    f"packer bound ({_PACK_MAX_NBITS})"))
        if spec.scheme == "quant" and not (0 < spec.bits <= 8):
            out.append(_finding(
                "RC003", "src/repro_torch/comm/codecs.py",
                f"{name}: quant bits={spec.bits} outside (0, 8] — the wire "
                f"plane is int8"))

    # --- shape/dtype algebra through the ops wrappers, on small CPU tensors
    #     (their plain versions: the kernels take no meta tensors)
    d = 1000
    w = -(-d // bp.PACK_BITS)
    gen = torch.Generator().manual_seed(0)
    mask = torch.rand(d, generator=gen) < 0.5
    x = torch.randn(d, generator=gen)
    noise = torch.rand((ops.tile_rows(d), q8.QBLOCK), generator=gen)
    checks = [
        ("pack_bits", lambda: ops.pack_bits(mask), (w,), torch.int32),
        ("unpack_bits", lambda: ops.unpack_bits(torch.zeros(w, dtype=torch.int32), d),
         (d,), torch.uint8),
        ("quantize_dequantize", lambda: ops.quantize_dequantize(x, noise),
         (d,), torch.float32),
    ]
    for label, run, want_shape, want_dtype in checks:
        try:
            res = run()
        except Exception as e:  # noqa: BLE001 — report, don't crash
            out.append(_finding(
                "RC003", f"{kpath}/ops.py", f"ops.{label}: failed: {_error(e)}"))
            continue
        if tuple(res.shape) != want_shape or res.dtype != want_dtype:
            out.append(_finding(
                "RC003", f"{kpath}/ops.py",
                f"ops.{label}: gave {tuple(res.shape)} {res.dtype}, expected "
                f"{want_shape} {want_dtype}"))

    # quantize_pack and the ring variant must agree on the wire planes
    rows = ops.tile_rows(d)
    for label, fn in (("quantize_pack", ops.quantize_pack),
                      ("stream_quantize_pack", ops.stream_quantize_pack)):
        try:
            q, s = fn(x, noise)
        except Exception as e:  # noqa: BLE001 — report, don't crash
            out.append(_finding(
                "RC003", f"{kpath}/ops.py", f"ops.{label}: failed: {_error(e)}"))
            continue
        want_q, want_s = (rows, q8.QBLOCK), (rows, 1)
        if tuple(q.shape) != want_q or q.dtype != torch.int8:
            out.append(_finding(
                "RC003", f"{kpath}/ops.py",
                f"ops.{label}: q plane {tuple(q.shape)} {q.dtype}, expected "
                f"{want_q} int8"))
        if tuple(s.shape) != want_s or s.dtype != torch.float32:
            out.append(_finding(
                "RC003", f"{kpath}/ops.py",
                f"ops.{label}: scales plane {tuple(s.shape)} {s.dtype}, "
                f"expected {want_s} float32"))

    # N:M prune keeps the logical (unpadded) shape
    try:
        w2 = torch.randn((200, 300), generator=gen)
        pruned, pmask = ops.prune_nm(w2, w2.abs())
        if tuple(pruned.shape) != (200, 300) or tuple(pmask.shape) != (200, 300):
            out.append(_finding(
                "RC003", f"{kpath}/ops.py",
                f"ops.prune_nm: output shapes {tuple(pruned.shape)}/"
                f"{tuple(pmask.shape)} != (200, 300)"))
    except Exception as e:  # noqa: BLE001 — report, don't crash
        out.append(_finding(
            "RC003", f"{kpath}/ops.py", f"ops.prune_nm: failed: {_error(e)}"))

    if torch.device(device).type == "cuda":
        out.extend(check_kernel_resources(device))
    return out


def run_contracts(device) -> List[Finding]:
    """All three contract families on ``device`` (``"cpu"``, or a CUDA device
    for the card half of RC003 and the kernels' own RC001/RC002 runs)."""
    out: List[Finding] = []
    for fn in (check_compressor_grid, check_payload_accounting,
               check_kernel_budgets):
        out.extend(fn(device))
    return out
