"""Production meshes on ``torch.distributed.device_mesh.DeviceMesh``: the
twin of ``repro.launch.mesh``.

The meshes are FUNCTIONS (not module-level constants), so importing this
module touches no process-group state.  A mesh takes the first ranks of
the process group the caller set up.  ``fake_world(n)`` sets up one of
``n`` ranks in this one process on torch's fake backend, which moves no
data: a mesh, its placements and every rank's local shape are real, but
only rank 0's tensors exist.  It is the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` dry run.
``threaded_world(n)`` runs ``n`` real ranks as threads of this process on
torch's threaded process group, whose collectives are plain tensor copies
and sums: every rank computes, and the ranks may share one device.  It
holds a sharded model to its one-device run on the CPU, or on one card.
Each rank thread runs its own backward (the threaded group sets
``torch.autograd.set_multithreading_enabled(False)`` in the thread that
builds it), so the transposes of the collectives (``models.sharding``)
meet in every rank's thread.
A production run is one process per card on NCCL, set up by the caller;
the meshes below are the same either way.

With ``device_type="cuda"`` (the default) and no card a mesh raises;
nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time

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


@contextlib.contextmanager
def threaded_world(n: int, timeout: float = 120.0):
    """A world of ``n`` ranks, each a thread of this process, for the
    ``with`` block: yields ``run(fn)``, which calls ``fn(rank)`` on every
    rank's thread inside its own threaded process group (set up before,
    destroyed after), joins each thread within ``timeout`` seconds and
    returns the ranks' results in rank order.  The first rank that raises
    wakes the ranks waiting in a collective (they exit), and ``run``
    raises its exception; a rank still running at the time limit makes
    ``run`` raise ``TimeoutError`` rather than wait.  The group and the
    thread isolation mode it needs are global: both are undone on leaving
    the block, so a later ``fake_world`` (or any other group) finds none."""
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    if dist.is_initialized():
        raise RuntimeError("threaded_world: a process group is already set up")
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = mt._install_threaded_pg()
    if not hasattr(world, "comms"):
        # some torch releases walk ``_world.comms`` in
        # ``destroy_process_group`` but give the threaded world none
        world.comms = []
    mt.ProcessLocalGroup.reset()

    def run(fn):
        store = dist.HashStore()
        results, errors = [None] * n, []

        def worker(rank):
            try:
                # the threaded group turns the engine's device threads off
                # in the rank's thread as it is built: each rank runs its
                # own backward, where a shared device thread would run every
                # rank's CUDA nodes and wait in a collective for ranks
                # queued behind it
                dist.init_process_group("threaded", rank=rank, world_size=n,
                                        store=store)
                try:
                    results[rank] = fn(rank)
                finally:
                    dist.destroy_process_group()
            except BaseException as e:          # noqa: B036 (SystemExit)
                errors.append((rank, e))
                mt.ProcessLocalGroup.exception_handle(e)

        threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                    name=f"rank{r}") for r in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        late = [t.name for t in threads if t.is_alive()]
        if late:                        # wake the ranks left in a collective
            mt.ProcessLocalGroup.exception_handle(None)
            for t in threads:
                t.join(5.0)
        mt.ProcessLocalGroup.reset()
        if late:
            raise TimeoutError(f"threaded_world: {', '.join(late)} still "
                               f"running after {timeout} s")
        # a rank that exits because another one failed raises SystemExit
        first = [e for _, e in sorted(errors, key=lambda re: re[0])
                 if not isinstance(e, SystemExit)] or [e for _, e in errors]
        if first:
            raise first[0]
        return results

    try:
        yield run
    finally:
        mt._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)


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
