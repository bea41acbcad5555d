"""WKV6 recurrence: the Hopper kernel's wrapper and its plain version.

``wkv6`` is the port of the Pallas kernel
``repro/kernels/rwkv6/kernel.py::wkv6_bht`` (wrapper ``ops.py::wkv6``)
and of the model's scan ``repro/models/rwkv.py::_wkv6_scan``, which the
model path runs: it takes the model layout (B, T, H, dh), an initial state
and returns the final one, so decode (T = 1) continues from a prefill.  A
CPU tensor goes to ``wkv6_plain``; a CUDA tensor launches
``csrc/wkv6.cu`` (r, k, v bf16, w f32, head size 16 or 64), which
reads the inputs through their strides with 16-byte asynchronous copies:
every input must start on a 16-byte boundary and every stride of r, k, v
(w) must be a multiple of 8 (4) elements, or the wrapper raises.  Inside
``build.dry_run()`` a meta tensor takes the dry run's route: the CUDA
path's checks and outputs on meta, its work (``wkv6_work``) tallied,
nothing launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

F32 = torch.float32
HEAD_SIZES = (16, 64)          # rwkv6-tiny, rwkv6-7b

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


def wkv6_plain(r, k, v, w, u, state0=None):
    """The reference's ``_wkv6_scan`` step by step, all in f32."""
    B, T, H, dh = r.shape
    S = (torch.zeros(B, H, dh, v.shape[-1], dtype=F32, device=r.device)
         if state0 is None else state0.to(F32))
    rf, kf, vf, wf = (t.to(F32) for t in (r, k, v, w))
    uf = u.to(F32)[None, :, :, None]
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,dk,dv)
        outs.append(((S + uf * kv) * rf[:, t, :, :, None]).sum(dim=-2))
        S = wf[:, t, :, :, None] * S + kv
    out = (torch.stack(outs, dim=1) if outs else
           torch.zeros(B, 0, H, v.shape[-1], dtype=F32, device=r.device))
    return out, S


def wkv6_work(B, T, H, dh, state_in: bool):
    """(f32 operations, bytes) of one call: per (b, t, h) w*S + k v^T (a
    multiply and an FMA) and r.S (an FMA) on dh^2 state elements, 5
    operations each, and the u term v_j * sum_i r_i u_i k_i with its add,
    5 a head lane; r, k, v (bf16), w and the output (f32) once, u, the
    state out (and in)."""
    n = B * T * H * dh
    return (n * (5 * dh + 5),
            n * (3 * 2 + 4 + 4) + H * dh * 4
            + (1 + state_in) * B * H * dh * dh * 4)


def _check(r, k, v, w, u, state0) -> None:
    B, T, H, dh = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, dh) or (state0 is not None
                                      and state0.shape != (B, H, dh, dh)):
        raise ValueError(
            f"wkv6 wants r, k, v, w (B,T,H,dh), u (H,dh), state0 "
            f"(B,H,dh,dh); got {tuple(r.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)} {tuple(w.shape)} {tuple(u.shape)} "
            f"{None if state0 is None else tuple(state0.shape)}")
    if len({t.device for t in (r, k, v, w, u, state0)
            if t is not None}) != 1:
        raise ValueError("wkv6: inputs on different devices")


def _cuda_checks(r, k, v, w, u, state0) -> None:
    dh = r.shape[-1]
    if dh not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head size {HEAD_SIZES}, "
                         f"not {dh}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1 \
                or t.stride() != r.stride():
            raise ValueError(f"wkv6 kernel wants bf16 {name} with a "
                             f"contiguous last dim and r's strides; got "
                             f"{t.dtype} strides {t.stride()}")
    if w.dtype != F32 or w.stride(-1) != 1:
        raise ValueError(f"wkv6 kernel wants f32 w with a contiguous last "
                         f"dim; got {w.dtype} strides {w.stride()}")
    for name, t in (("u", u), ("state0", state0)):
        if t is not None and (t.dtype != F32 or not t.is_contiguous()):
            raise ValueError(f"wkv6 kernel wants contiguous f32 {name}; "
                             f"got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w),
                    ("state0", state0)):
        if t is None:
            continue
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                s % per16 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"wkv6 kernel copies 16-byte rows: {name} must start on a "
                f"16-byte boundary with strides in multiples of {per16} "
                f"elements; got address {t.data_ptr()} % 16 = "
                f"{t.data_ptr() % 16}, strides {t.stride()}")


def wkv6(r, k, v, w, u, state0=None):
    """r, k, v, w: (B, T, H, dh); u: (H, dh); state0: (B, H, dh, dh) or
    None (zeros).  Returns (out (B, T, H, dh) f32, S_T (B, H, dh, dh)
    f32)."""
    build.refuse_dtensor("wkv6", r, k, v, w, u, state0)
    _check(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state0)
    dry = build.on_meta("wkv6", r)
    if not dry and r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    build.refuse_autograd("wkv6", r, k, v, w, u, state0)
    _cuda_checks(r, k, v, w, u, state0)
    B, T, H, dh = r.shape
    out = torch.empty(B, T, H, dh, dtype=F32, device=r.device)
    s_T = torch.empty(B, H, dh, dh, dtype=F32, device=r.device)
    if dry:
        build.tally("wkv6", wkv6_work(B, T, H, dh, state0 is not None),
                    out, s_T)
        return out, s_T
    fn = build.function("wkv6", "wkv6", _ARGTYPES)
    err = build.launch(r.device, fn, r.data_ptr(), k.data_ptr(),
                       v.data_ptr(), w.data_ptr(), u.data_ptr(),
                       None if state0 is None else state0.data_ptr(),
                       out.data_ptr(), s_T.data_ptr(), B, T, H, dh,
                       *r.stride()[:3], *w.stride()[:3])
    if err:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    build.count(wkv6)
    return out, s_T


wkv6.launches = 0
