"""Production meshes on ``torch.distributed.device_mesh.DeviceMesh``: the
twin of ``repro.launch.mesh``.

The meshes are FUNCTIONS (not module-level constants), so importing this
module touches no process-group state.  A mesh takes the first ranks of
the process group the caller set up.  ``fake_world(n)`` sets up one of
``n`` ranks in this one process on torch's fake backend, which moves no
data: a mesh, its placements and every rank's local shape are real, but
only rank 0's tensors exist.  It is the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` dry run.

With ``device_type="cuda"`` (the default) and no card a mesh raises;
nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on the fake backend, this process
    rank 0, for the ``with`` block; destroyed on leaving it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh: CUDA is not available; pass "
                           "device_type='cpu' to build a mesh on the CPU")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks but the process group has "
            f"{have} — set one up first, e.g. the fake world of "
            f"repro_torch.launch.mesh.fake_world({need}) for a dry run")
    return DeviceMesh(device_type, torch.arange(need).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_worker_mesh(n_devices: int = 1, tp: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """(n_devices / tp, tp) ("data", "model") mesh."""
    dp = max(1, n_devices // tp)
    return _mesh((dp, tp), ("data", "model"), device_type)
