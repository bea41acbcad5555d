"""Mamba-1 selective-SSM layer (jamba's mixer) in PyTorch: the twin of
``repro.models.mamba``.

Both of the reference's scans go through the ``mamba_scan`` kernel: the
prefill scan ``_ssm_scan`` (zero state in, each step's h.C rounded to
bf16) and the decode branch of ``mamba_layer`` (the carried state in, no
rounding).  With ``train=True`` the prefill scan runs through
``layers.seq_scan`` under autograd instead, as the reference trains.
The causal depthwise conv stays plain PyTorch (an f32 sum of d_conv
shifted products, cast back).

On a mesh (an ``env`` whose ``ShardingEnv`` carries one) ``mamba_layer``
takes and returns DTensors, in serving and in training (``train=True``:
the scan through ``_ssm_scan_train`` on the rank's channels).  Each rank
takes its batch rows of the stream with the whole sequence (the conv and
the scan need every earlier token; under ``sp`` the stream arrives with
its sequence over 'model') and runs on its ``d_inner / tp`` channels,
the reference's ``cs(xr, batch, None, "model")``: ``in_proj`` (``_COL``)
gives each rank a column block of the product [xr | z], which does not
line up with the split at ``d_inner``, so the blocks are gathered over
'model' and each rank takes its channels of xr and of z; the conv,
``dt``, ``mamba_scan`` and the gate run on those channels with the
rank's slices of ``conv_w``, ``conv_b``, ``dt_w``, ``dt_b``, ``A_log``,
``D`` and of the carried ``conv`` / ``ssm`` states.  ``x_proj``'s
contraction runs over the split channels: its f32 partial products are
summed over 'model' and rounded once, so ``dt | B | C`` are whole on
every rank.  ``out_proj`` (``_ROW``) is an f32 sum still pending over
'model'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models import layers as L
from repro_torch.models.layers import seq_scan
from repro_torch.models.sharding import all_gather, psum

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


def mamba_layer(x, p, cfg, env=None, *, conv_state=None, ssm_state=None,
                return_state: bool = False, train: bool = False):
    """Full-sequence mamba mixer.  x: (B,S,d) -> (B,S,d).

    With ``return_state`` also returns (conv_state, ssm_state) for the
    serving cache: conv_state (B, d_conv-1, di), ssm_state (B, di, ds).
    """
    if L.on_mesh(env):
        return _mamba_sharded(x, p, cfg, env, conv_state, ssm_state,
                              return_state, train)
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


def _mamba_sharded(x, p, cfg, env, conv_state, ssm_state, return_state,
                   train=False):
    """``mamba_layer`` on a mesh: the rank's rows (the whole sequence) and
    channels; the output an f32 sum pending over 'model' where the
    channels split.  With ``train`` the scan runs ``_ssm_scan_train`` on
    those channels."""
    B, S, d = x.shape
    di, ds, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
    if ssm_state is not None:
        rows = L.sharding_spec(ssm_state, env)[0]
    else:
        rows = env.spec(x.shape, [env.batch_axes, None, None])[0]
    ch = env.spec((B, S, di), [rows, None, "model"])[2]
    c0, n = L._heads(env, ch, di)
    xl = L._local(x, env, rows, None, None)
    w_in = p["in_proj"]
    xz = xl @ L._local(w_in, env, None, "model")
    if env.spec(w_in.shape, [None, "model"])[1] is not None:
        xz = all_gather(xz, env, "model", 2)       # [xr | z] whole
    xr, z = xz[..., c0:c0 + n], xz[..., di + c0:di + c0 + n]
    conv_w = L._local(p["conv_w"], env, ch, None)
    conv_b = L._local(p["conv_b"], env, ch)
    if conv_state is not None:
        prev = L._local(conv_state, env, rows, None, ch).to(xr.dtype)
        xr_in = torch.cat([prev, xr], dim=1)
        xr_c = _causal_depthwise_conv(xr_in, conv_w, conv_b)
        xr_c = xr_c[:, prev.shape[1]:, :]
    else:
        xr_in = xr
        xr_c = _causal_depthwise_conv(xr, conv_w, conv_b)
    xc = F.silu(xr_c)
    x_proj = L._local(p["x_proj"], env, None, None)[c0:c0 + n]
    dbc = psum(xc.float() @ x_proj.float(), env, ch).to(x.dtype)
    dt = F.softplus(dbc[..., :dtr] @ L._local(p["dt_w"], env, None, ch)
                    + L._local(p["dt_b"], env, ch))
    Bc = dbc[..., dtr:dtr + ds]
    Cc = dbc[..., dtr + ds:]
    A = -torch.exp(L._local(p["A_log"], env, ch, None).float())
    D = L._local(p["D"], env, ch).float()
    if ssm_state is not None:
        h0 = L._local(ssm_state, env, rows, ch, None).float()
        y, h_T = mamba_scan(xc, dt, Bc, Cc, A, D, h0)
        y = y.to(x.dtype)
    else:
        y, h_T = (_ssm_scan_train if train else _ssm_scan)(xc, dt, Bc, Cc,
                                                           A, D)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = L._global(y.float() @ L._local(p["out_proj"], env, ch,
                                         None).float(),
                    env, (B, S, d), [rows, None, None], partial=ch)
    if not return_state:
        return out
    k = cfg.mamba_d_conv - 1
    tail = F.pad(xr_in, (0, 0, max(0, k - xr_in.shape[1]), 0))[:, -k:, :]
    return (out, L._global(tail.contiguous(), env, (B, k, di),
                           [rows, None, ch]),
            L._global(h_T, env, (B, di, ds), [rows, ch, None]))
