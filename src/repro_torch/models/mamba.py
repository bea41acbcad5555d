"""Mamba-1 selective-SSM layer (jamba's mixer) in PyTorch: the twin of
``repro.models.mamba``.

Both of the reference's scans go through the ``mamba_scan`` kernel: the
prefill scan ``_ssm_scan`` (zero state in, each step's h.C rounded to
bf16) and the decode branch of ``mamba_layer`` (the carried state in, no
rounding).  With ``train=True`` the prefill scan runs through
``layers.seq_scan`` under autograd instead, as the reference trains.
The causal depthwise conv stays plain PyTorch (an f32 sum of d_conv
shifted products, cast back).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models.layers import seq_scan

F32 = torch.float32


def _causal_depthwise_conv(x, w, b):
    """x: (B,S,di); w: (di, k); left-padded causal depthwise conv."""
    k = w.shape[1]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for j in range(k):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :S, :]
        out = out + xs.float() * w[:, j].float()
    return (out + b.float()).to(x.dtype)


def _ssm_scan(x, dt, Bc, Cc, A, D):
    """x,dt: (B,S,di); Bc,Cc: (B,S,ds); A: (di,ds); D: (di,).  The prefill
    scan from a zero state, each step's h.C rounded to bf16.  Returns
    (y in x's type, h_T (B, di, ds) f32)."""
    y, h_T = mamba_scan(x, dt, Bc, Cc, A, D.float(), round_y=True)
    return y.to(x.dtype), h_T


def _ssm_scan_train(x, dt, Bc, Cc, A, D):
    """The training route of ``_ssm_scan``: the reference's step
    (``repro/models/mamba.py:35-41``) through ``seq_scan``, with dt*x
    formed in f32 as ``mamba_scan_plain`` forms it (ROADMAP Queue 3, held
    differences) and each step's h.C rounded to bf16.  Returns (y in x's
    type, h_T (B, di, ds) f32)."""
    Af = A.float()[None]

    def step(h, inp):
        xt, dtt, bt, ct = inp
        dtf = dtt.float()
        h = torch.exp(dtf[:, :, None] * Af) * h \
            + (dtf * xt.float())[:, :, None] * bt.float()[:, None, :]
        return h, torch.einsum("bis,bs->bi", h, ct.float()).to(
            torch.bfloat16)

    B, _, di = x.shape
    h0 = torch.zeros(B, di, A.shape[1], dtype=F32, device=x.device)
    h_T, ys = seq_scan(step, h0, tuple(t.transpose(0, 1)
                                       for t in (x, dt, Bc, Cc)))
    y = ys.transpose(0, 1).float() + x.float() * D.float()
    return y.to(x.dtype), h_T


def mamba_layer(x, p, cfg, *, conv_state=None, ssm_state=None,
                return_state: bool = False, train: bool = False):
    """Full-sequence mamba mixer.  x: (B,S,d) -> (B,S,d).

    With ``return_state`` also returns (conv_state, ssm_state) for the
    serving cache: conv_state (B, d_conv-1, di), ssm_state (B, di, ds).
    """
    B, S, d = x.shape
    di = cfg.mamba_d_inner
    ds = cfg.mamba_d_state
    dtr = cfg.dt_rank

    xz = x @ p["in_proj"]
    xr, z = xz[..., :di], xz[..., di:]
    if conv_state is not None:
        xr_in = torch.cat([conv_state.to(xr.dtype), xr], dim=1)
        xr_c = _causal_depthwise_conv(xr_in, p["conv_w"], p["conv_b"])
        xr_c = xr_c[:, conv_state.shape[1]:, :]
    else:
        xr_c = _causal_depthwise_conv(xr, p["conv_w"], p["conv_b"])
    xc = F.silu(xr_c)

    dbc = xc @ p["x_proj"]                     # (B,S,dtr+2ds)
    dt = F.softplus(dbc[..., :dtr] @ p["dt_w"] + p["dt_b"])
    Bc = dbc[..., dtr:dtr + ds]
    Cc = dbc[..., dtr + ds:]
    A = -torch.exp(p["A_log"].float())

    if ssm_state is not None:
        # decode: continue the scan from the carried state, unrounded
        y, h_T = mamba_scan(xc, dt, Bc, Cc, A, p["D"].float(),
                            ssm_state.float())
        y = y.to(x.dtype)
    else:
        scan = _ssm_scan_train if train else _ssm_scan
        y, h_T = scan(xc, dt, Bc, Cc, A, p["D"])

    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        k = cfg.mamba_d_conv - 1
        if conv_state is not None:
            tail = torch.cat([conv_state.to(xr.dtype), xr], dim=1)[:, -k:, :]
        else:
            tail = F.pad(xr, (0, 0, max(0, k - S), 0))[:, -k:, :]
        return out, tail, h_T
    return out
