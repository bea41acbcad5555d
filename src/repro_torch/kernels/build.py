"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source ``repro_torch/csrc/<name>.cu`` has a plain C interface (no
PyTorch headers, so a build takes seconds) and compiles into its own
shared library under ``build/kernels/`` at the root of the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so <name>.cu

The file name carries a hash of the source and the flags, so an edited
source never loads a stale library.  Nothing is built when a module is
imported: ``build_all`` starts one nvcc per source at once and waits for
all of them, and ``function`` builds its library on first use.  A missing
nvcc or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "paged_attention", "wkv6", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}
# the ranks of a threaded world call the wrappers from several threads
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# a thread's open ``counted_apart`` tally (``tally``), if any
_APART = threading.local()
# the open dry run's tally: {kernel: {"calls", "flops", "bytes",
# "alloc_bytes"}}, or None
_DRY: Optional[Dict[str, Dict[str, int]]] = None
_DRY_KEPT: Optional[dict] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes running at once.  Returns the compiler's output per source
    built (ptxas register and spill counts); raises on any failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, tmp, out, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(lib: str, fn: str, argtypes: Sequence):
    """The C function ``fn`` of library ``lib`` with its argument types
    declared; it returns the kernel launch's ``cudaGetLastError()``."""
    key = (lib, fn)
    f = _FUNCS.get(key)
    if f is None:
        with _BUILD_LOCK:
            if key not in _FUNCS:
                if lib not in _LIBS:
                    build_all([lib])
                    _LIBS[lib] = ctypes.CDLL(str(library_path(lib)))
                f = getattr(_LIBS[lib], fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                _FUNCS[key] = f
            f = _FUNCS[key]
    return f


def count(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: the ranks of a
    threaded world launch from several threads at once.  Inside
    ``counted_apart`` the launch goes to that block's tally instead."""
    tally = getattr(_APART, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def counted_apart():
    """Yield a tally {wrapper: launches} that this thread's launches inside
    the ``with`` block go to, and not to the wrappers' ``launches``.  A
    CUDA graph's warm-up and capture run so: the capture launches nothing
    on the card, and a replay adds what it tallied (``add_counts``), so
    ``launches`` counts what ran, as an eager call does."""
    tally: Dict[object, int] = {}
    outer = getattr(_APART, "tally", None)
    _APART.tally = tally
    try:
        yield tally
    finally:
        _APART.tally = outer


def add_counts(tally: Dict[object, int]) -> None:
    """Add a ``counted_apart`` tally to its wrappers' ``launches``."""
    with _COUNT_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n


@contextlib.contextmanager
def dry_run():
    """The dry run's route for the ``with`` block (one at a time, for
    every thread): yields the tally {kernel: {"calls", "flops", "bytes",
    "alloc_bytes"}} that the wrappers given meta tensors add to."""
    global _DRY, _DRY_KEPT
    with _COUNT_LOCK:
        if _DRY is not None:
            raise RuntimeError("build.dry_run: a dry run is already open")
        _DRY = tally = {}
        _DRY_KEPT = {}
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _DRY = _DRY_KEPT = None


def dry_kept() -> dict:
    """The open dry run's store for the buffers a CUDA path makes once a
    process and keeps (``paged_decode``'s tickets): empty at each dry
    run's start, so every measured step makes and holds them, as a card's
    first step does, wherever the step falls in its process."""
    return _DRY_KEPT


def on_meta(name: str, t) -> bool:
    """True where the wrapper ``name`` takes the dry run's route: ``t`` a
    meta tensor inside ``dry_run``.  A meta tensor outside it raises."""
    if t.device.type != "meta":
        return False
    if _DRY is None:
        raise ValueError(f"{name}: unsupported device meta (a meta tensor "
                         f"is measured only inside build.dry_run())")
    return True


def tally(name: str, work, *allocated) -> None:
    """Add one call of kernel ``name`` to the open dry run's tally: ``work``
    its (operations, bytes), ``allocated`` the meta tensors its route made
    as the CUDA path makes them."""
    with _COUNT_LOCK:
        rec = _DRY.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0,
                                     "alloc_bytes": 0})
        rec["calls"] += 1
        rec["flops"] += int(work[0])
        rec["bytes"] += int(work[1])
        rec["alloc_bytes"] += sum(t.untyped_storage().nbytes()
                                  for t in allocated)


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` on a DTensor: a kernel takes a rank's local
    shard (``to_local()``).  On the CPU a DTensor would pass the device
    test and run the plain version under DTensor's sharding propagation,
    while on the card the kernel would read the local shard's pointer, so
    the CPU would not check what the card runs."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and any(isinstance(t, mod.DTensor) for t in tensors):
        raise TypeError(f"{name} takes rank-local tensors, not a DTensor: "
                        f"pass each rank's shard (to_local())")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where a kernel would be launched under autograd.  The kernels
    write through raw pointers, so their outputs carry no ``grad_fn``: every
    weight before the call would silently get no gradient.  None has a
    backward (nor has any of the reference's Pallas kernels); training
    takes the plain PyTorch path (``train=True`` in the model functions)."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and was given a "
            f"tensor that requires grad; training takes the plain path "
            f"(train=True), inference runs under torch.no_grad()")


def launch(device, fn, *args):
    """Call ``fn(*args, stream)`` with ``device`` current and its current
    stream: the C functions launch on the runtime's current device.  The
    raw stream handle and the device check cost far less than
    ``torch.cuda.current_stream`` and a device context, which matters on
    the host-bound decode loop."""
    import torch

    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)
