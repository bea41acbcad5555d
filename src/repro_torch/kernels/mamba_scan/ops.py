"""Mamba selective scan: the Hopper kernel's wrapper and its plain version.

``mamba_scan`` is the port of the Pallas kernel
``repro/kernels/mamba_scan/kernel.py::mamba_scan_btd`` (wrapper
``ops.py::mamba_scan``) and of the model's scans in
``repro/models/mamba.py``: ``_ssm_scan`` (prefill, ``round_y=True``: each
step's h.C is rounded to bf16 before D*x is added) and the decode branch
of ``mamba_layer`` (``round_y=False``, from a carried state).  It takes
A = -exp(A_log) as the model's scans do, an initial state, and returns
the final one.  A CPU tensor goes to ``mamba_scan_plain``; a CUDA tensor
launches ``csrc/mamba_scan.cu`` (x, dt, B, C bf16, A and D f32, d_state 8
or 16), which reads B and C through their strides at any offset and x and
dt by 16-byte copies.  Inside ``build.dry_run()`` a meta tensor takes the
dry run's route: the CUDA path's checks and outputs on meta, its work
(``mamba_scan_work``) tallied, nothing launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

F32 = torch.float32
STATE_SIZES = (8, 16)
# rounding_errs' limits on a kernel's rounding mode against the plain
# version: the largest difference past the f32 slack, in bf16 steps of h.C,
# and the share of elements that differ past it
ROUND_STEPS = 1.0001
ROUND_SHARE = 1e-2

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])


def mamba_scan_work(B, T, di, ds, state_in: bool):
    """(f32 operations, bytes) of one call: 7 ds + 3 a channel and step
    (exp(dt A), the state update and h.C on ds state elements; dt x, the
    D x term and its add); x, dt (bf16), B, C (bf16) and y (f32) once, A
    and D, the state out (and in)."""
    return (B * T * di * (7 * ds + 3),
            B * T * di * (2 + 2 + 4) + 2 * B * T * ds * 2 + di * ds * 4
            + di * 4 + (1 + state_in) * B * di * ds * 4)


def mamba_scan_plain(x, dt, Bc, Cc, A, D, h0=None, *, round_y=False):
    """The model's scan step by step, in f32.  dt*x is an f32 product:
    the reference writes it in the inputs' type but XLA keeps the f32
    value it casts to (excess precision), and the Pallas kernel forms it
    in f32."""
    B, T, di = x.shape
    h = (torch.zeros(B, di, A.shape[1], dtype=F32, device=x.device)
         if h0 is None else h0.to(F32))
    Af = A.to(F32)[None]
    dtf, Bf, Cf = dt.to(F32), Bc.to(F32), Cc.to(F32)
    dbx = dtf * x.to(F32)
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + dbx[:, t, :, None] * Bf[:, t, None, :]
        yt = torch.einsum("bis,bs->bi", h, Cf[:, t])
        ys.append(yt.to(torch.bfloat16).to(F32) if round_y else yt)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros(B, 0, di, dtype=F32, device=x.device))
    return y + x.to(F32) * D.to(F32), h


def hc_scale(x, dt, Bc, Cc, A, h0=None):
    """The scale of each step's sum h.C, sum_s |h_s * C_s| (B, T, di), from
    the plain scan run in f64."""
    f64 = torch.float64
    B, T, di = x.shape
    h = (torch.zeros(B, di, A.shape[1], dtype=f64, device=x.device)
         if h0 is None else h0.to(f64))
    Af = A.to(f64)[None]
    dtf, Bf, Cf = dt.to(f64), Bc.to(f64), Cc.to(f64)
    dbx = dtf * x.to(f64)
    out = []
    for t in range(T):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + dbx[:, t, :, None] * Bf[:, t, None, :]
        out.append((h * Cf[:, t, None, :]).abs().sum(-1))
    return (torch.stack(out, dim=1) if out else
            torch.zeros(B, 0, di, dtype=f64, device=x.device))


def rounding_errs(y, ref, x, dt, Bc, Cc, A, D, h0=None):
    """A rounding-mode output ``y`` = bf16(h.C) + D*x against ``ref``, the
    plain version's, on the scan inputs both were given.

    Two f32 sums h.C taken in different orders differ by a few f32
    roundings of the sum's own scale, sum_s |h_s C_s| (``hc_scale``), not of
    |h.C|, which is far smaller where the sum nearly cancels.  Past that
    slack (8 f32 epsilons of the scale and of |D*x|) the two rounded sums
    are equal or one bf16 step of h.C apart.  Returns (the largest
    difference past the slack, in bf16 steps of the larger |h.C|; the share
    of elements that differ past it), for the limits ROUND_STEPS and
    ROUND_SHARE.  An unrounded output lies within half a step of the
    rounded one, so it passes the first limit and fails the second on
    nearly every element."""
    f64 = torch.float64
    xD = x.to(f64) * D.to(f64)
    d = (y.to(f64) - ref.to(f64)).abs()
    slack = 8 * torch.finfo(F32).eps * (hc_scale(x, dt, Bc, Cc, A, h0)
                                        + xD.abs())
    # one bf16 step (8 significant bits) at the larger of the two |h.C|
    _, e = torch.frexp((ref.to(f64) - xD).abs() + d)
    step = torch.ldexp(torch.ones_like(d), e - 8)
    return (float(((d - slack).clamp_min(0) / step).max()),
            float((d > slack).to(f64).mean()))


def _check(x, dt, Bc, Cc, A, D, h0) -> None:
    B, T, di = x.shape
    ds = A.shape[-1]
    if dt.shape != x.shape or Bc.shape != (B, T, ds) \
            or Cc.shape != Bc.shape or A.shape != (di, ds) \
            or D.shape != (di,) or (h0 is not None
                                    and h0.shape != (B, di, ds)):
        raise ValueError(
            f"mamba_scan wants x, dt (B,T,di), Bc, Cc (B,T,ds), A (di,ds), "
            f"D (di,), h0 (B,di,ds); got {tuple(x.shape)} {tuple(dt.shape)} "
            f"{tuple(Bc.shape)} {tuple(Cc.shape)} {tuple(A.shape)} "
            f"{tuple(D.shape)} {None if h0 is None else tuple(h0.shape)}")
    if len({t.device for t in (x, dt, Bc, Cc, A, D, h0)
            if t is not None}) != 1:
        raise ValueError("mamba_scan: inputs on different devices")


def _cuda_checks(x, dt, Bc, Cc, A, D, h0) -> None:
    ds = A.shape[-1]
    if ds not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel takes d_state {STATE_SIZES}, "
                         f"not {ds}")
    for name, t in (("x", x), ("dt", dt), ("Bc", Bc), ("Cc", Cc)):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"mamba_scan kernel wants bf16 {name} with a "
                             f"contiguous last dim; got {t.dtype} strides "
                             f"{t.stride()}")
    for name, t in (("A", A), ("D", D), ("h0", h0)):
        if t is not None and (t.dtype != F32 or not t.is_contiguous()):
            raise ValueError(f"mamba_scan kernel wants contiguous f32 "
                             f"{name}; got {t.dtype}")
    # x and dt come in by 16-byte copies, h0 as 16-byte runs a lane
    for name, t in (("x", x), ("dt", dt), ("h0", h0)):
        if t is None:
            continue
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                s % per16 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"mamba_scan kernel copies 16-byte rows: {name} must start "
                f"on a 16-byte boundary with strides in multiples of "
                f"{per16} elements; got address {t.data_ptr()} % 16 = "
                f"{t.data_ptr() % 16}, strides {t.stride()}")


def _launch(fn, x, dt, Bc, Cc, A, D, h0, round_y):
    """Checks the inputs and launches the kernel through the C function
    ``fn`` (``mamba_scan``'s signature; called with None on the dry run's
    route, which launches nothing)."""
    _check(x, dt, Bc, Cc, A, D, h0)
    dry = build.on_meta("mamba_scan", x)
    if not dry and x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    build.refuse_autograd("mamba_scan", x, dt, Bc, Cc, A, D, h0)
    _cuda_checks(x, dt, Bc, Cc, A, D, h0)
    B, T, di = x.shape
    ds = A.shape[1]
    y = torch.empty(B, T, di, dtype=F32, device=x.device)
    h_T = torch.empty(B, di, ds, dtype=F32, device=x.device)
    if dry:
        build.tally("mamba_scan", mamba_scan_work(B, T, di, ds,
                                                  h0 is not None), y, h_T)
        return y, h_T
    strides = [s for t in (x, dt, Bc, Cc) for s in t.stride()[:2]]
    err = build.launch(x.device, fn, x.data_ptr(), dt.data_ptr(),
                       Bc.data_ptr(), Cc.data_ptr(), A.data_ptr(),
                       D.data_ptr(), None if h0 is None else h0.data_ptr(),
                       y.data_ptr(), h_T.data_ptr(), B, T, di, ds,
                       int(round_y), *strides)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    return y, h_T


def mamba_scan(x, dt, Bc, Cc, A, D, h0=None, *, round_y: bool = False):
    """x, dt: (B, T, di); Bc, Cc: (B, T, ds); A: (di, ds) (already
    -exp(A_log)); D: (di,); h0: (B, di, ds) or None (zeros).  Returns
    (y (B, T, di) f32 without gating, h_T (B, di, ds) f32)."""
    build.refuse_dtensor("mamba_scan", x, dt, Bc, Cc, A, D, h0)
    if x.device.type == "cpu":
        _check(x, dt, Bc, Cc, A, D, h0)
        return mamba_scan_plain(x, dt, Bc, Cc, A, D, h0, round_y=round_y)
    if x.device.type == "meta":
        return _launch(None, x, dt, Bc, Cc, A, D, h0, round_y)
    out = _launch(build.function("mamba_scan", "mamba_scan", _ARGTYPES),
                  x, dt, Bc, Cc, A, D, h0, round_y)
    build.count(mamba_scan)
    return out


mamba_scan.launches = 0


def kernel_config(ds: int):
    """(lanes a channel, registers a thread, dynamic shared memory a CTA in
    bytes, CTAs an SM) of the kernel's ring entry on the current card, and
    the larger local memory a thread of its two entries in bytes (above 0:
    a spill), from the CUDA runtime."""
    out = (ctypes.c_int * 5)()
    fn = build.function("mamba_scan", "mamba_scan_config",
                        [ctypes.c_int, ctypes.c_void_p])
    err = fn(ds, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"mamba_scan_config failed: CUDA error {err}")
    return tuple(out)
