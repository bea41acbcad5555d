"""RWKV-6 "Finch" layer (data-dependent decay) in PyTorch: the twin of
``repro.models.rwkv``.

Time mix (the WKV6 recurrence, through the ``wkv6`` kernel; with
``train=True`` through ``layers.seq_scan`` under autograd, as the
reference trains) and channel mix, both with token shift and the ddlerp
data-dependent interpolation [arXiv:2404.05892].  The reference's
rounding points are kept: each ddlerp mix is rounded to the activations' type, the decay is f32, and the wkv
output goes through ``group_norm_heads`` to bf16.  The reference's
sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.layers import group_norm_heads, seq_scan

F32 = torch.float32
DDLERP_W = 32      # ddlerp lora width
DECAY_W = 64       # decay lora width


def _token_shift(x, last):
    """Returns x_{t-1} with ``last`` (B, d) as the t=0 predecessor."""
    if last is None:
        last = torch.zeros_like(x[:, :1, :])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _wkv6_scan(r, k, v, w, u, state0):
    """The training route: the reference's ``_wkv6_scan`` step
    (``repro/models/rwkv.py:30-44``, the same arithmetic as
    ``wkv6_plain``'s loop body), f32 inputs and state, through
    ``seq_scan``.  r, k, v, w (B, S, H, dh); u (H, dh).  Returns (out (B,
    S, H, dh) f32, S_T (B, H, dh, dh) f32)."""
    uf = u.float()[None, :, :, None]

    def step(S, inp):
        rt, kt, vt, wt = inp                       # (B, H, dk|dv)
        kv = kt[..., :, None] * vt[..., None, :]   # (B, H, dk, dv)
        out = ((S + uf * kv) * rt[..., :, None]).sum(dim=-2)
        return wt[..., :, None] * S + kv, out

    B, _, H, dh = r.shape
    if state0 is None:
        state0 = torch.zeros(B, H, dh, v.shape[-1], dtype=F32,
                             device=r.device)
    xs = tuple(t.float().transpose(0, 1) for t in (r, k, v, w))
    S_T, outs = seq_scan(step, state0.float(), xs)
    return outs.transpose(0, 1), S_T


def rwkv6_time_mix(x, p, cfg, *, shift_state=None, wkv_state=None,
                   return_state: bool = False, train: bool = False):
    B, S, d = x.shape
    H = cfg.rwkv_n_heads
    hs = cfg.rwkv_head_size

    xprev = _token_shift(x, shift_state)
    dx = (xprev - x).float()
    xf = x.float()

    xxx = xf + dx * p["maa_x"].float()
    kk = torch.tanh(xxx @ p["maa_w1"].float()).reshape(B, S, 5, DDLERP_W)
    mix = torch.einsum("bsfw,fwd->fbsd", kk, p["maa_w2"].float())
    mw, mk, mv, mr, mg = mix.unbind(0)

    xw = (xf + dx * (p["maa_w"].float() + mw)).to(x.dtype)
    xk = (xf + dx * (p["maa_k"].float() + mk)).to(x.dtype)
    xv = (xf + dx * (p["maa_v"].float() + mv)).to(x.dtype)
    xr = (xf + dx * (p["maa_r"].float() + mr)).to(x.dtype)
    xg = (xf + dx * (p["maa_g"].float() + mg)).to(x.dtype)

    r = (xr @ p["Wr"]).reshape(B, S, H, hs)
    k = (xk @ p["Wk"]).reshape(B, S, H, hs)
    v = (xv @ p["Wv"]).reshape(B, S, H, hs)
    g = F.silu((xg @ p["Wg"]).float())

    dec = p["decay"].float() + \
        torch.tanh(xw.float() @ p["decay_w1"].float()) @ \
        p["decay_w2"].float()                                 # (B,S,d)
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, hs)

    scan = _wkv6_scan if train else wkv6
    out, s_T = scan(r, k, v, w, p["faaaa"].float(), wkv_state)

    out = group_norm_heads(out.reshape(B, S, d), p["ln_x"], H, cfg.norm_eps)
    out = (out.float() * g).to(x.dtype)
    y = out @ p["Wo"]
    if return_state:
        return y, x[:, -1, :], s_T
    return y


def rwkv6_channel_mix(x, p, cfg, *, shift_state=None,
                      return_state: bool = False):
    xprev = _token_shift(x, shift_state)
    dx = (xprev - x).float()
    xf = x.float()
    xk = (xf + dx * p["cmix_maa_k"].float()).to(x.dtype)
    xr = (xf + dx * p["cmix_maa_r"].float()).to(x.dtype)
    h = torch.square(torch.relu(xk @ p["Wck"]))
    v = h @ p["Wcv"]
    y = (torch.sigmoid((xr @ p["Wcr"]).float()) * v.float()).to(x.dtype)
    if return_state:
        return y, x[:, -1, :]
    return y
