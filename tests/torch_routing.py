"""Holds the port to the reference's discrete picks where bf16 rounding
can flip them: the MoE router's top-k (``SameRouting``) and a MoE
engine's greedy next token (``SameArgmax``).

SameRouting.

The two frameworks round the residual stream at other places, so a
one-ulp difference meets a near-tie of the top-k pick on a few tokens
per prompt (seen: a reference gap of 2.4e-4 against a logit difference
of 2.9e-3, ROADMAP.md Queue 3), and one other expert moves that row's
logits far past TOL.  So the reference runs each call first, with its
picks concrete (its layers unrolled, or its engine under
``jax.disable_jit()``), and records them; the port's router then returns
the reference's expert ids in the same call order, weighted by its own
probabilities.  Each token where the port would have picked otherwise
must be a near-tie of the reference (its k-th vs (k+1)-th gap below 4x
the frameworks' probability difference); tests/test_torch_ssm.py holds
the router's own picks.

``traced=True`` records inside a jitted and differentiated reference
(``jax.debug.callback``, ordered: a ``lax.scan`` over layers or a
``jax.checkpoint`` leaves the picks abstract), and replays a pick already
made for the same router input and weight without taking another: the
port's ``torch.utils.checkpoint`` (remat) calls the router again in the
backward.  A remat reference records each call twice, the forward's
first, so the port's forward takes the first half in order."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm


class SameRouting:
    """``rows`` (a sharded port run in a threaded world): each rank thread
    replays every recorded call from its own queue, taking the token rows
    ``rows(n, m)`` .. + m of a call of ``n`` recorded rows where its own
    call routes ``m`` (its batch shard); with ``traced`` too (a sharded
    training run), a recomputed call replays the rank's own pick."""

    def __init__(self, monkeypatch, traced=False, rows=None):
        self.calls, self.flips, held = [], 0, {}
        j_router, t_router = jl.moe_router, tl.moe_router
        mine, lock = threading.local(), threading.Lock()

        def take():
            if rows is None:
                return self.calls.pop(0)
            if not hasattr(mine, "queue"):
                mine.queue = list(self.calls)
            return mine.queue.pop(0)

        def record(x2d, w, k):
            p, e = j_router(x2d, w, k)
            probs = jax.nn.softmax((x2d @ w).astype(jnp.float32), axis=-1)
            if traced:
                jax.debug.callback(lambda pr, ids: self.calls.append(
                    (np.array(pr), np.array(ids))), probs, e, ordered=True)
            else:
                self.calls.append((np.array(probs), np.array(e)))
            return p, e

        def picks():
            """The picks already replayed: each rank thread's own where
            ``rows`` is given (two ranks of one data shard route the same
            rows)."""
            if rows is None:
                return held
            if not hasattr(mine, "held"):
                mine.held = {}
            return mine.held

        def replay(x2d, w, k):
            # a sharded run gathers the router weight anew at each call, a
            # recomputed one too: key it by its values there
            wkey = (w.data_ptr() if rows is None
                    else w.detach().float().numpy().tobytes())
            key = (wkey, x2d.detach().float().numpy().tobytes())
            done = picks()
            if traced and key in done:
                probs_j, ids_j = done[key]
            else:
                probs_j, ids_j = take()
                done[key] = probs_j, ids_j
            if rows is not None:
                start = rows(probs_j.shape[0], x2d.shape[0])
                probs_j = probs_j[start:start + x2d.shape[0]]
                ids_j = ids_j[start:start + x2d.shape[0]]
            _, own = t_router(x2d, w, k)
            probs = torch.softmax((x2d @ w).float(), dim=-1)
            assert probs.shape == probs_j.shape, "router calls out of step"
            p_own = probs.detach().numpy()
            flip = (np.sort(own.numpy(), -1) != np.sort(ids_j, -1)).any(-1)
            if flip.any():
                srt = -np.sort(-probs_j[flip], axis=-1)
                gap = srt[:, k - 1] - srt[:, k]
                diff = np.abs(p_own[flip] - probs_j[flip]).max(-1)
                assert (gap < 4 * diff).all(), (gap, diff)
                with lock:
                    self.flips += int(flip.sum())
            ids = torch.from_numpy(ids_j).long()
            top_p = probs.gather(1, ids)
            return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), ids

        monkeypatch.setattr(jl, "moe_router", record)
        monkeypatch.setattr(tl, "moe_router", replay)


class SameArgmax:
    """Holds the port engine's greedy pick to the reference engine's where
    their logits nearly tie; for the MoE engines only, where the replayed
    router picks still leave the two frameworks' logits a few ulps apart.
    The reference engine's jitted decode functions record each step's
    logits; the port's ``lm.decode_step`` / ``lm.decode_step_paged`` then
    take them in call order.  Every row's logits must agree within the lm
    tests' limit (``tol`` relative to the row's largest magnitude where
    that passes 1), parted pick or not.  A row whose argmax differs must
    also be a near-tie of the reference (its top-2 logit gap below the
    row's largest logit difference); at most ``max_flips`` rows in all
    may part, and only those rows' logits become the reference's, so the
    next token and the rest of the script stay comparable."""

    def __init__(self, monkeypatch, ref_engine, tol=2e-2, max_flips=1):
        self.logits, self.flips = [], 0
        self.tol, self.max_flips = tol, max_flips
        for attr in ("_jit_decode", "_jit_paged_decode"):
            monkeypatch.setattr(ref_engine, attr,
                                self._record(getattr(ref_engine, attr)))
        for name in ("decode_step", "decode_step_paged"):
            monkeypatch.setattr(tlm, name, self._hold(getattr(tlm, name)))

    def _record(self, fn):
        def call(*args):
            out = fn(*args)
            self.logits.append(np.array(out[0][:, 0].astype(jnp.float32)))
            return out
        return call

    def _hold(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            ref = self.logits.pop(0)
            own = out[0][:, 0].float().numpy()
            assert own.shape == ref.shape, "decode calls out of step"
            part = parted_argmax(own, ref, self.tol)
            if not part.any():
                return out
            self.flips += int(part.sum())
            assert self.flips <= self.max_flips, self.flips
            logits = out[0].clone()
            logits[torch.from_numpy(part), 0] = torch.from_numpy(
                ref[part]).to(logits.dtype)
            return (logits, *out[1:])
        return call


def parted_argmax(own, ref, tol=2e-2):
    """Rows of logits (..., V) held to the reference's: each row within
    ``tol`` of ``ref`` relative to its largest magnitude where that passes
    1, and each row whose greedy pick differs a near-tie of the reference
    (its top-2 gap below the row's largest difference).  Returns the mask
    of the rows whose pick differs."""
    own = np.asarray(own, np.float32).reshape(-1, own.shape[-1])
    ref = np.asarray(ref, np.float32).reshape(-1, ref.shape[-1])
    diff = np.abs(own - ref).max(-1)
    top = np.maximum(1.0, np.abs(ref).max(-1))
    assert (diff < tol * top).all(), (diff, top)
    part = own.argmax(-1) != ref.argmax(-1)
    top2 = -np.sort(-ref[part], axis=-1)[:, :2]
    gap = top2[:, 0] - top2[:, 1]
    assert (gap < diff[part]).all(), (gap, diff[part])
    return part
