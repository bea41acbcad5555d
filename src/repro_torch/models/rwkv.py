"""RWKV-6 "Finch" layer (data-dependent decay) in PyTorch: the twin of
``repro.models.rwkv``.

Time mix (the WKV6 recurrence, through the ``wkv6`` kernel; with
``train=True`` through ``layers.seq_scan`` under autograd, as the
reference trains) and channel mix, both with token shift and the ddlerp
data-dependent interpolation [arXiv:2404.05892].  The reference's
rounding points are kept: each ddlerp mix is rounded to the activations' type, the decay is f32, and the wkv
output goes through ``group_norm_heads`` to bf16.

On a mesh (an ``env`` whose ``ShardingEnv`` carries one) both mixes take
and return DTensors, in serving and in training (``train=True``: the
recurrence through ``_wkv6_scan`` on the rank's heads).  Each rank takes
its batch rows of the stream with the whole sequence before the token
shift (under ``sp`` the stream
arrives with its sequence over 'model': a shift on the shard would lose
the previous token at each shard boundary), and its heads of ``Wr`` /
``Wk`` / ``Wv`` / ``Wg`` (``_COL``: whole heads where ``H % tp == 0``, as
the reference's ``cs(r, batch, None, "model", None)``); ``wkv6`` runs on
those heads with the rank's slices of ``faaaa`` and of the carried
``wkv`` state, ``group_norm_heads`` is per head, and the ``Wo`` product
(``_ROW``) is an f32 sum still pending over 'model'.  The channel mix's
``h`` splits its d_ff over 'model' (the reference's ``cs(h, batch, None,
"model")``); the ``Wcv`` products are summed in f32 and rounded once
before the gate, as one device rounds the whole product once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models import layers as L
from repro_torch.models.layers import group_norm_heads, seq_scan
from repro_torch.models.sharding import psum

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


def _mix(x, xprev, p):
    """The ddlerp inputs (xw, xk, xv, xr, xg) of the time mix, each
    rounded to x's type."""
    B, S, _ = x.shape
    dx = (xprev - x).float()
    xf = x.float()
    xxx = xf + dx * p["maa_x"].float()
    kk = torch.tanh(xxx @ p["maa_w1"].float()).reshape(B, S, 5, DDLERP_W)
    mix = torch.einsum("bsfw,fwd->fbsd", kk, p["maa_w2"].float())
    return tuple((xf + dx * (p[f"maa_{n}"].float() + m)).to(x.dtype)
                 for n, m in zip("wkvrg", mix.unbind(0)))


def rwkv6_time_mix(x, p, cfg, env=None, *, shift_state=None,
                   wkv_state=None, return_state: bool = False,
                   train: bool = False):
    if L.on_mesh(env):
        return _time_mix_sharded(x, p, cfg, env, shift_state, wkv_state,
                                 return_state, train)
    B, S, d = x.shape
    H = cfg.rwkv_n_heads
    hs = cfg.rwkv_head_size

    xw, xk, xv, xr, xg = _mix(x, _token_shift(x, shift_state), p)

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


_TM_WHOLE = ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g", "maa_w1",
             "maa_w2", "decay", "decay_w1", "decay_w2", "ln_x")


def _rows(x, state, env):
    """The batch entry a mix computes its rows under: the carried state's
    (a decode: ``cache_pspecs`` puts the batch over the batch axes, or
    nowhere under ``serve_fullshard``), else the batch axes."""
    if state is not None:
        return L.sharding_spec(state, env)[0]
    return env.spec(x.shape, [env.batch_axes, None, None])[0]


def _time_mix_sharded(x, p, cfg, env, shift_state, wkv_state, return_state,
                      train=False):
    """``rwkv6_time_mix`` on a mesh: the rank's rows (the whole sequence)
    and heads; y an f32 sum pending over 'model' where the heads split.
    With ``train`` the recurrence runs ``_wkv6_scan`` on those heads."""
    B, S, d = x.shape
    H, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    rows = _rows(x, wkv_state, env)
    heads = env.spec((B, S, H, hs), [rows, None, "model", None])[2]
    h0, Hl = L._heads(env, heads, H)
    ch = slice(h0 * hs, (h0 + Hl) * hs)
    xl = L._local(x, env, rows, None, None)
    last = (None if shift_state is None
            else L._local(shift_state, env, rows, None))
    pw = L._whole(p, env, _TM_WHOLE)
    xw, xk, xv, xr, xg = _mix(xl, _token_shift(xl, last), pw)
    Bl = xl.shape[0]
    col = {n: L._local(p[n], env, None, heads) for n in ("Wr", "Wk", "Wv",
                                                         "Wg")}
    r = (xr @ col["Wr"]).reshape(Bl, S, Hl, hs)
    k = (xk @ col["Wk"]).reshape(Bl, S, Hl, hs)
    v = (xv @ col["Wv"]).reshape(Bl, S, Hl, hs)
    g = F.silu((xg @ col["Wg"]).float())
    dec = pw["decay"][ch].float() + \
        torch.tanh(xw.float() @ pw["decay_w1"].float()) @ \
        pw["decay_w2"][:, ch].float()
    w = torch.exp(-torch.exp(dec)).reshape(Bl, S, Hl, hs)
    state = (None if wkv_state is None
             else L._local(wkv_state, env, rows, heads, None, None))
    scan = _wkv6_scan if train else wkv6
    out, s_T = scan(r, k, v, w, L._local(p["faaaa"], env, heads,
                                         None).float(), state)
    out = group_norm_heads(out.reshape(Bl, S, Hl * hs), pw["ln_x"][ch], Hl,
                           cfg.norm_eps)
    out = (out.float() * g).to(x.dtype)
    y = L._global(out.float() @ L._local(p["Wo"], env, heads, None).float(),
                  env, (B, S, d), [rows, None, None], partial=heads)
    if not return_state:
        return y
    return (y, L._global(xl[:, -1, :].contiguous(), env, (B, d),
                         [rows, None]),
            L._global(s_T, env, (B, H, hs, hs), [rows, heads, None, None]))


def rwkv6_channel_mix(x, p, cfg, env=None, *, shift_state=None,
                      return_state: bool = False):
    if L.on_mesh(env):
        return _channel_mix_sharded(x, p, cfg, env, shift_state,
                                    return_state)
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


def _channel_mix_sharded(x, p, cfg, env, shift_state, return_state):
    """``rwkv6_channel_mix`` on a mesh: the rank's rows (the whole
    sequence) and d_ff columns; the ``Wcv`` products summed over 'model'
    in f32 and rounded once, then gated: y whole on each rank of a row."""
    B, S, d = x.shape
    rows = _rows(x, shift_state, env)
    ff = env.spec((B, S, cfg.d_ff), [rows, None, "model"])[2]
    xl = L._local(x, env, rows, None, None)
    last = (None if shift_state is None
            else L._local(shift_state, env, rows, None))
    pw = L._whole(p, env, ("cmix_maa_k", "cmix_maa_r", "Wcr"))
    dx = (_token_shift(xl, last) - xl).float()
    xf = xl.float()
    xk = (xf + dx * pw["cmix_maa_k"].float()).to(x.dtype)
    xr = (xf + dx * pw["cmix_maa_r"].float()).to(x.dtype)
    h = torch.square(torch.relu(xk @ L._local(p["Wck"], env, None, ff)))
    v = psum(h.float() @ L._local(p["Wcv"], env, ff, None).float(), env,
             ff).to(x.dtype)
    y = (torch.sigmoid((xr @ pw["Wcr"]).float()) * v.float()).to(x.dtype)
    y = L._global(y, env, (B, S, d), [rows, None, None])
    if return_state:
        return y, L._global(xl[:, -1, :].contiguous(), env, (B, d),
                            [rows, None])
    return y
