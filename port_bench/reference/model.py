"""The plain reference: a decoder (Mistral's dense block, or Mixtral's
sparse one) in float32, written from the published architecture.

It imports nothing of the program.  It reads the benchmark's weights (the
same bf16 tree the program serves, upcast here layer by layer) and works
out every key and value again from the token ids.  Each layer: RMSNorm,
grouped-query attention with rotary embeddings (the half-split rotation of
the published implementation), RMSNorm, then a SwiGLU FFN, or a router
that keeps the ``top_k`` experts of its softmax, renormalised, and sums
their SwiGLU outputs.  The final RMSNorm then the unembedding give the
logits.

A session is a list of chunks, the segments of its cache as the served
path keeps them by design:

* ``full``: a causal prefill of the whole context from position 0; it
  replaces the cache (a first admission, or a context regenerated after
  its KV was evicted);
* ``delta``: a resumed step's new tokens prefilled on their own, positions
  counted from 0 and attending to themselves only, their K/V appended to
  the cache;
* ``decode``: one step's decoded inputs (the prompt's last token, then
  each served token but the last) at the positions after the cache,
  each attending to the whole cache and to the chunk's earlier tokens.

``fp8=True`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude over
448), accumulating in float32, which is the step below the configurations'
bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
Q_BLOCK = 256            # query rows a block of the attention scores


@dataclasses.dataclass
class Chunk:
    kind: str                      # full | delta | decode
    ids: np.ndarray
    want: bool = False             # logits at every position


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
    def __init__(self, params: Dict, m: Dict, *, fp8: bool = False,
                 margins: bool = False):
        self.p = params
        self.m = m
        self.fp8 = fp8
        # with ``margins``: per wanted chunk, each position's smallest
        # router margin over the layers (the k-th largest logit less the
        # next), how near a routing decision came to a tie
        self.margins: Optional[Dict] = {} if margins else None
        self._key = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- operands -------------------------------------------------------
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(F32)
        return _q8(t) if self.fp8 else t

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_q8(x) if self.fp8 else x) @ w

    def _rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.m["norm_eps"]) * w.to(F32)

    def _rope(self, x, pos):
        D = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, D, 2, dtype=F32, device=x.device) / D))
        ang = pos.to(F32)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attend(self, q, k, v, off: int):
        """q (S, H, dh) at cache positions off..off+S-1; k, v (T, K, dh).
        Query i sees keys j <= off + i."""
        S, H, dh = q.shape
        T, K, _ = k.shape
        G = H // K
        if self.fp8:
            q, k, v = _q8(q), _q8(k), _q8(v)
        qg = q.view(S, K, G, dh)
        out = torch.empty(S, K, G, dh, dtype=F32, device=q.device)
        keys = torch.arange(T, device=q.device)
        for i in range(0, S, Q_BLOCK):
            qb = qg[i:i + Q_BLOCK]
            hi = min(T, off + i + qb.shape[0])
            s = torch.einsum("skgd,tkd->kgst", qb, k[:hi]) / dh ** 0.5
            rows = off + i + torch.arange(qb.shape[0], device=q.device)
            s.masked_fill_(keys[None, :hi] > rows[:, None], float("-inf"))
            pr = torch.softmax(s, dim=-1)
            if self.fp8:
                pr = _q8(pr)
            out[i:i + qb.shape[0]] = torch.einsum("kgst,tkd->skgd", pr,
                                                  v[:hi])
        return out.view(S, H, dh)

    def _ffn(self, h, W):
        if "router" not in W:
            a = F.silu(self._mm(h, W["w1"])) * self._mm(h, W["w3"])
            return self._mm(a, W["w2"])
        logits = self._mm(h, W["router"])
        if self.margins is not None and self._key is not None:
            k = self.m["top_k"]
            top = logits.topk(k + 1, -1).values
            gap = top[:, k - 1] - top[:, k]
            old = self.margins.get(self._key)
            self.margins[self._key] = gap if old is None \
                else torch.minimum(old, gap)
        top_p, top_e = torch.softmax(logits, -1).topk(self.m["top_k"], -1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        y = torch.zeros_like(h)
        for e in range(W["router"].shape[1]):
            tok, slot = (top_e == e).nonzero(as_tuple=True)
            if not len(tok):
                continue
            x = h[tok]
            a = F.silu(self._mm(x, W["w1"][e])) * self._mm(x, W["w3"][e])
            y.index_add_(0, tok, self._mm(a, W["w2"][e])
                         * top_p[tok, slot, None])
        return y

    def _layer_weights(self, i: int) -> Dict:
        lp = self.p["layers"]
        d = self.m["d_model"]
        a = lp["attn"]
        W = {"wq": self._w(a["wq"][i].reshape(d, -1)),
             "wk": self._w(a["wk"][i].reshape(d, -1)),
             "wv": self._w(a["wv"][i].reshape(d, -1)),
             "wo": self._w(a["wo"][i].reshape(-1, d)),
             "ln1": lp["ln1"][i], "ln2": lp["ln2"][i]}
        for k, t in lp["mlp"].items():
            W[k] = self._w(t[i])
        return W

    # -- the forward ------------------------------------------------------
    def logits(self, sessions: List[List[Chunk]]
               ) -> List[List[Optional[torch.Tensor]]]:
        """For each session, per chunk, its f32 logits (S, V) where the
        chunk is ``want``ed, else None."""
        p, m = self.p, self.m
        H, K, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        dev = p["embed"].device
        ids = [[torch.as_tensor(c.ids, dtype=torch.long, device=dev)
                for c in s] for s in sessions]
        xs = [[p["embed"][t].to(F32) for t in s] for s in ids]
        with torch.no_grad():
            for i in range(m["n_layers"]):
                W = self._layer_weights(i)
                for s, chunks in enumerate(sessions):
                    self._session_layer(W, chunks, xs[s], H, K, dh, s)
                del W
            out = []
            un = self._w(p["unembed"])
            for s, chunks in enumerate(sessions):
                out.append([self._mm(self._rms(x, p["final_norm"]), un)
                            if c.want else None
                            for c, x in zip(chunks, xs[s])])
        return out

    def _session_layer(self, W, chunks, xs, H, K, dh, s) -> None:
        kc = vc = None
        for j, c in enumerate(chunks):
            self._key = (s, j) if c.want else None
            x = xs[j]
            S = x.shape[0]
            h = self._rms(x, W["ln1"])
            q = self._mm(h, W["wq"]).view(S, H, dh)
            k = self._mm(h, W["wk"]).view(S, K, dh)
            v = self._mm(h, W["wv"]).view(S, K, dh)
            start = 0 if c.kind != "decode" else kc.shape[0]
            pos = torch.arange(start, start + S, device=x.device)
            q, k = self._rope(q, pos), self._rope(k, pos)
            if c.kind == "full":
                kc, vc = k, v
                a = self._attend(q, k, v, 0)
            elif c.kind == "delta":
                a = self._attend(q, k, v, 0)
                kc, vc = torch.cat([kc, k]), torch.cat([vc, v])
            elif c.kind == "decode":
                kc, vc = torch.cat([kc, k]), torch.cat([vc, v])
                a = self._attend(q, kc, vc, kc.shape[0] - S)
            else:
                raise ValueError(f"unknown chunk kind {c.kind!r}")
            x = x + self._mm(a.reshape(S, H * dh), W["wo"])
            xs[j] = x + self._ffn(self._rms(x, W["ln2"]), W)
