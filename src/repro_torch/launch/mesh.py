"""The production meshes (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches
neither CUDA nor a process group.  A mesh is a ``DeviceMesh`` over the
current default process group, whose world size must equal the mesh's
size: 256 or 512 ranks, which on one host only the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``) provides.
"""
from __future__ import annotations


def _device_type() -> str:
    """The process group's device type: "cuda" under NCCL, else "cpu"."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over the current process group; ``device_type``
    defaults to the group's (the dry-run's fake group takes the device type
    of its fake tensors)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """A (data, model) mesh over whatever world exists (tests, examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    data = n // model
    if data * model != n:
        data, model = n, 1
    return init_device_mesh(_device_type(), (data, model), mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM5 constants for the roofline analysis (NVIDIA H100 Tensor
# Core GPU datasheet: dense bf16 without sparsity, HBM3, NVLink 4)
PEAK_FLOPS_BF16 = 989.4e12      # per device
HBM_BW = 3.35e12                # bytes/s per device
NVLINK_BW = 450e9               # bytes/s per direction per device (900 GB/s total)

