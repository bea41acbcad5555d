"""Holds one run of a MoE model to the expert picks another run made.

Two runs of the same tokens (the card and the CPU, or prefill + decode and
the full forward) round the residual stream differently, and on a
near-tie of the top-k pick one other expert moves that row's logits far
past any rounding tolerance.  ``SameRouting.record`` stores each router
call's probabilities and picks; ``replay`` makes the router return
recorded picks in call order, weighted by its own probabilities.  Each
token where it would have picked otherwise is counted and must be a
near-tie of the recording (its k-th vs (k+1)-th gap below 4x the two
runs' probability difference).  A checking aid: the model itself never
uses it."""
from __future__ import annotations

import threading

import torch

from repro_torch.models import layers as L


class SameRouting:
    """``setattr`` patches ``layers.moe_router`` (pytest's
    ``monkeypatch.setattr`` undoes it at teardown); ``restore`` puts the
    router back."""

    def __init__(self, setattr=setattr):
        self._set, self.router = setattr, L.moe_router
        self.calls, self.flips, self.gaps = [], 0, []

    def record(self):
        def rec(x2d, w, k):
            p, e = self.router(x2d, w, k)
            # detached: under autograd the record would keep the run's
            # graph, so every tensor and param behind it, alive
            self.calls.append((torch.softmax((x2d @ w).float(), -1)
                               .detach(), e))
            return p, e
        self._set(L, "moe_router", rec)

    def replay(self, calls=None, rows=None):
        """Replay ``calls`` (the recorded ones where not given).  Each
        thread takes them in order from its own queue, so the ranks of a
        threaded world each replay the whole run; ``rows(n, m)`` gives the
        first of a call's ``n`` recorded token rows that a rank's call of
        ``m`` rows routes (its batch shard)."""
        source = list(self.calls if calls is None else calls)
        mine, lock = threading.local(), threading.Lock()

        def rep(x2d, w, k):
            if not hasattr(mine, "queue"):
                mine.queue = list(source)
            probs_r, ids_r = (t.to(x2d.device) for t in mine.queue.pop(0))
            if rows is not None:
                start = rows(probs_r.shape[0], x2d.shape[0])
                probs_r = probs_r[start:start + x2d.shape[0]]
                ids_r = ids_r[start:start + x2d.shape[0]]
            _, own = self.router(x2d, w, k)
            probs = torch.softmax((x2d @ w).float(), -1)
            flip = (own.sort(-1).values != ids_r.sort(-1).values).any(-1)
            if bool(flip.any()):
                srt = probs_r[flip].sort(-1, descending=True).values
                gap = srt[:, k - 1] - srt[:, k]
                diff = (probs[flip] - probs_r[flip]).abs().amax(-1)
                if not bool((gap < 4 * diff).all()):
                    raise AssertionError(f"router pick differs away from a "
                                         f"near-tie: gap {gap.tolist()} vs "
                                         f"difference {diff.tolist()}")
                with lock:
                    self.flips += int(flip.sum())
                    self.gaps += gap.tolist()
            top_p = probs.gather(1, ids_r)
            return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), ids_r
        self._set(L, "moe_router", rep)

    def by_position(self, B, S, n_dec):
        """The picks recorded over a prefill of S tokens then n_dec decode
        steps, per MoE layer as (probs (B, S + n_dec, E), ids (B, S +
        n_dec, k)) in position order."""
        n = len(self.calls) // (1 + n_dec)
        out = []
        for layer in range(n):
            steps = [self.calls[layer]] + [self.calls[n * (1 + j) + layer]
                                           for j in range(n_dec)]
            out.append(tuple(
                torch.cat([c[i].reshape(B, -1, c[i].shape[-1])
                           for c in steps], 1) for i in (0, 1)))
        return out

    def restore(self):
        self._set(L, "moe_router", self.router)
