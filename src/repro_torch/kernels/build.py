"""Build the CUDA kernels with nvcc and bind them through ctypes.

``csrc/quant.cu`` (B1-B3, B6), ``csrc/bitmask.cu`` (B4, B5) and
``csrc/prune.cu`` (B7, B8) are compiled on first use into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``_build/`` by a hash of the sources and the flags:
one nvcc per source, all started together, then one link.  Nothing here
runs at import
time: the CPU tests import every module on a machine with neither nvcc nor a
card.

Flags pin the numerics the kernels promise: no fast-math, IEEE division and
square root, no flush-to-zero, no FMA contraction.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = (CSRC / "quant.cu", CSRC / "bitmask.cu", CSRC / "prune.cu")
HEADERS = (CSRC / "resources.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
    "-Xptxas", "-v",
)

# C entry points: name -> argtypes (pointers and the stream as c_void_p)
_P, _I64, _I32, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_NM = (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P)
_WANDA = (_P,) * 8 + (_I64, _I64, _I32, _F, _F, _P, _P, _I32, _I64, _I64, _I64, _P)
# resource reports (csrc/resources.cuh): (idx, d_in, out fields, name, name_len)
_RES = (_I32, _I64, ctypes.POINTER(_I64), ctypes.c_char_p, _I32)
RESOURCE_ENTRIES = {"quant.cu": "repro_quant_resources",
                    "bitmask.cu": "repro_bitmask_resources",
                    "prune.cu": "repro_prune_resources"}
# the report's fields, in resources.cuh's order
RESOURCE_FIELDS = ("count", "threads", "dyn_smem", "cluster", "regs", "static_smem",
                   "local", "max_threads", "occupancy", "staged", "optin")
SIGNATURES = {
    "repro_quant_dequant_2d": (_P, _P, _P, _I64, _I32, _P),
    "repro_quant_pack_2d": (_P, _P, _P, _P, _I64, _I32, _P),
    "repro_unpack_dequant_2d": (_P, _P, _P, _I64, _P),
    "repro_stream_quant_pack_2d": (_P, _P, _P, _P, _I64, _I32, _P),
    "repro_pack_mask_2d": (_P, _P, _I64, _P),
    "repro_unpack_mask_2d": (_P, _P, _I64, _P),
    "repro_nm_prune_2d_f32": _NM,
    "repro_nm_prune_2d_bf16": _NM,
    "repro_wanda_prune_2d_f32": _WANDA,
    "repro_wanda_prune_2d_bf16": _WANDA,
    **{entry: _RES for entry in RESOURCE_ENTRIES.values()},
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""   # nvcc's output of the last build (the ptxas -v report)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the source."""


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> Path:
    """Where the library lives: named by a hash of the sources + flags."""
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def nvcc_commands(out: Path, nvcc: str = "nvcc") -> tuple:
    """-> (one compile command per source, each writing ``out``'s name with
    the source's stem and ``.o``, the link command into ``out``)."""
    objs = [out.with_name(f"{out.stem}-{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)]
    return compiles, [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]


def build() -> Path:
    """Compile the library unless it is already built; return its path.

    Raises ``KernelBuildError`` with nvcc's output if the compile fails.
    """
    global BUILD_LOG
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmp)
    compiles, link = nvcc_commands(tmp, nvcc_path())
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [p.communicate()[0] for p in procs]
    failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode != 0:
            failed = ["the link"]
    BUILD_LOG = "".join(logs)
    for cmd in compiles:
        Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {', '.join(failed)}:\n{BUILD_LOG}")
    os.replace(tmp, path)    # atomic: concurrent builds agree
    return path


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` with ``args`` (tensors become their data
    pointers) on ``device``'s current stream; raise on a nonzero error."""
    lib = load()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*conv, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: {msg} ({err})")


def resources(entry: str, idx: int, device: torch.device, d_in: int = 0) -> dict:
    """The launch-resource report of kernel ``idx`` of C entry ``entry``
    (``RESOURCE_FIELDS`` plus its ``name``) on ``device``; raise on a
    nonzero error."""
    lib = load()
    out = (ctypes.c_longlong * len(RESOURCE_FIELDS))()
    name = ctypes.create_string_buffer(128)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(idx, d_in, out, name, len(name))
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}({idx}, d_in={d_in}) failed: {msg} ({err})")
    return {"name": name.value.decode(), **dict(zip(RESOURCE_FIELDS, out))}


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: Optional[torch.device] = None,
                 align: int = 16) -> None:
    """Raise on what the kernels do not take: wrong dtype, shape, device or
    a non-contiguous / misaligned buffer."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors (or the CPU's plain "
                         f"version); got a tensor on {t.device}")
