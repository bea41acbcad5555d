"""``correct``: what the timed path served, held to the plain reference.

Once the window has closed and the program's state is freed, a sample of
the steps that served tokens in the window (``harness.sample_steps``: the
longest context among them, a resumed step that hit its parked KV, one
that regenerated its context, and others from more than half of the
engine's slots) is run again through the reference, each session from
its last full prefill before the sampled step.  The reference gets the
prompts the benchmark generated and the tokens the program served, and
works the KV out again as the served path keeps it by design
(``reference.model``'s chunks).  Which resumes found their KV parked and
which were regenerated is the runtime's eviction decision: the reference
follows it from the harness's record of each admission.

Numbers compared, each against its limit in the cell file:

* ``logit_gap_max``: the widest gap by which a served token's logit lies
  below the reference's best at its position (greedy decoding serves the
  program's best);
* ``ctx_mismatch``: sampled sessions whose runtime context differs from
  the prompts and served tokens (exact: limit 0);
* ``out_mismatch``: sampled steps whose runtime outputs differ from the
  tokens the engine's rounds returned, or not of the step's length (a
  session's last step may be shorter: the window closed while it
  decoded);
* ``kv_len_mismatch``: sampled sessions whose engine still holds KV of
  another length than the reference's cache.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference.model import Chunk, Reference


def session_chunks(prompts: List[np.ndarray], kinds: List[str],
                   served: List[List[int]], want: List[bool]) -> List[Chunk]:
    """The chunks of one session up to its last wanted step: per step j a
    prefill (the whole context for a first admission or a regeneration,
    the step's prompt alone for a hit) then, once it has served tokens,
    its decode inputs: the prompt's last token, then each served token
    but the last.  Chunks before the last full prefill at or before the
    first wanted step are left out: that prefill replaces the cache they
    made."""
    chunks, ctx = [], []
    last = max(i for i, w in enumerate(want) if w)
    for j in range(last + 1):
        p = np.asarray(prompts[j], np.int64)
        ctx.extend(p.tolist())
        if kinds[j] == "hit":
            chunks.append(Chunk("delta", p))
        elif kinds[j] in ("first", "regen"):
            chunks.append(Chunk("full", np.asarray(ctx, np.int64)))
        else:
            raise ValueError(f"unknown admission kind {kinds[j]!r}")
        if served[j]:
            inputs = [ctx[-1]] + list(served[j][:-1])
            chunks.append(Chunk("decode", np.asarray(inputs, np.int64),
                                want[j]))
        ctx.extend(served[j])
    first = next((i for i, c in enumerate(chunks) if c.want), len(chunks))
    start = max([i for i, c in enumerate(chunks[:first + 1])
                 if c.kind == "full"], default=0)
    return chunks[start:]


def kv_length(chunks: List[Chunk]) -> int:
    n = 0
    for c in chunks:
        n = len(c.ids) if c.kind == "full" else n + len(c.ids)
    return n


def compare(rec, host: Dict, sample: List[Tuple[str, int]], *,
            control: bool = False) -> Dict[str, float]:
    """The compared numbers for ``sample``; with ``control`` also the
    ``control_gap_*`` numbers, of the token the fp8 reference puts first
    at each position, and for sparse experts how near the reference's
    routing came to a tie where the program's pick lies over 1 logit
    below its best and elsewhere."""
    by_sid: Dict[str, List[int]] = {}
    for sid, j in sample:
        by_sid.setdefault(sid, []).append(j)
    sessions, targets = [], []
    ctx_bad = out_bad = kv_bad = 0
    for sid, js in sorted(by_sid.items()):
        steps = rec.steps[sid]
        task = rec.tasks[sid]
        served = [s.tokens for s in steps]
        want = [j in js for j in range(len(steps))]
        chunks = session_chunks(task.prompts, [s.kind for s in steps],
                                served, want)
        sessions.append(chunks)
        targets.append([served[j] for j in range(len(steps)) if want[j]])
        h_ctx, h_out, h_kv = host[sid]
        full = []
        for j in range(len(steps)):
            full.extend(np.asarray(task.prompts[j]).tolist())
            full.extend(served[j])
        ctx_bad += h_ctx[:len(full)] != full
        # only a session's last step may have served less than its length:
        # it was still decoding when the window closed
        last = len(steps) - 1
        out_bad += sum(h_out[j] != served[j]
                       or len(served[j]) > steps[j].n_out
                       or len(served[j]) < steps[j].n_out and j < last
                       for j in js)
        every = session_chunks(task.prompts, [s.kind for s in steps],
                               served, [True] * len(steps))
        kv_bad += h_kv >= 0 and h_kv != kv_length(every)
    reference = Reference(rec.params, rec.m,
                          margins=control and bool(rec.m["n_experts"]))
    ref = reference.logits(sessions)
    gaps, cgaps, margins = [], [], []
    ctl = Reference(rec.params, rec.m, fp8=True).logits(sessions) \
        if control else None
    for s, chunks in enumerate(sessions):
        wanted = [i for i, c in enumerate(chunks) if c.want]
        for i, tgt in zip(wanted, targets[s]):
            lg = ref[s][i]
            best = lg.max(dim=-1).values
            t = torch.as_tensor(tgt, device=lg.device)
            gaps.append(best - lg.gather(1, t[:, None])[:, 0])
            if reference.margins is not None:
                margins.append(reference.margins[(s, i)])
            if ctl is not None:
                top = ctl[s][i].argmax(dim=-1)
                cgaps.append(best - lg.gather(1, top[:, None])[:, 0])
    out = {"ctx_mismatch": ctx_bad, "out_mismatch": out_bad,
           "kv_len_mismatch": kv_bad,
           "tokens_compared": sum(len(t) for ts in targets for t in ts)}
    out.update(gap_numbers("logit_gap", gaps))
    if control:
        out.update(gap_numbers("control_gap", cgaps))
    if margins:
        g, mg = torch.cat(gaps), torch.cat(margins)
        far = g > 1.0
        out["router_margin_median_far"] = mg[far].median().item() \
            if far.any() else float("nan")
        out["router_margin_median_near"] = mg[~far].median().item()
        out["near_tie_share_far"] = 100.0 * (mg[far] < 0.05).float() \
            .mean().item() if far.any() else float("nan")
        out["near_tie_share_near"] = 100.0 * (mg[~far] < 0.05).float() \
            .mean().item()
    return out


def gap_numbers(name: str, gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The widest gap, and the share of positions whose gap passes 0.5
    and 1.0 logit, in %: NaN where nothing was compared."""
    if not gaps:
        return {f"{name}_max": float("nan"), f"{name}_over_0.5": float("nan"),
                f"{name}_over_1": float("nan")}
    g = torch.cat(gaps).float()
    return {f"{name}_max": g.max().item(),
            f"{name}_over_0.5": 100.0 * (g > 0.5).float().mean().item(),
            f"{name}_over_1": 100.0 * (g > 1.0).float().mean().item()}


def as_control(numbers: Dict[str, float]) -> Dict[str, float]:
    """``numbers`` with the control in the program's place: each
    ``control_gap_*`` reading under its ``logit_gap_*`` name, so that
    ``verdict`` judges the control by the cell's own limits (the host
    state's checks stay the program's)."""
    out = dict(numbers)
    for k, v in numbers.items():
        if k.startswith("control_gap_"):
            out["logit_gap_" + k[len("control_gap_"):]] = v
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= lim for k, lim in limits.items())
