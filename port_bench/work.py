"""Operations and bytes: the yardstick of the roofline and utilisation
metrics.

``visible_pairs``, ``flash_prefill_work``, ``paged_decode_work`` and
``paged_append_work`` are frozen copies of
``repro_torch/kernels/flash_attention/ops.py`` and
``repro_torch/kernels/paged_attention/ops.py`` at commit 3d2082b (only
``visible_pairs`` gained a closed form, equal to the loop it replaces), so
a later change to a kernel's own count cannot move its roofline.  Each
counts every input byte read once and every output byte written once.

The model counts below are the benchmark's own, from the configuration's
shapes alone: a sparse layer is counted at its experts per token, whatever
the program computes.
"""
from __future__ import annotations

from typing import Dict


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs one head scores: key j visible to query t
    where j <= t (causal) and t - j < window (window > 0).  Without a
    window the loop of the original has a closed form."""
    if not window:
        if not causal:
            return Sq * Sk
        full = min(Sq, Sk)
        return full * (full + 1) // 2 + max(0, Sq - Sk) * Sk
    n = 0
    for t in range(Sq):
        hi = min(t, Sk - 1) if causal else Sk - 1
        lo = max(0, t - window + 1)
        n += max(0, hi - lo + 1)
    return n


def flash_prefill_work(B, Sq, Sk, H, K, D, Dv, *, causal=True, window=0,
                       cap=0.0, itemsize=2):
    """(operations, bytes) of one call: 2 (D + Dv) a visible pair (the
    q.k and p.v products), and with a cap 3 more; q, k, v read once and
    the output written once."""
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    flops = (2 * (D + Dv) + (3 if cap else 0)) * pairs
    nbytes = itemsize * (B * Sq * H * (D + Dv) + B * Sk * K * (D + Dv))
    return flops, nbytes


def paged_decode_work(B, H, K, dh, nb, visible, itemsize=2):
    """(operations, bytes) of one decode call over ``visible`` K/V
    positions in all (the rows' visible lengths summed): 4 dh a query
    head and position, q read and the output written once, the tables
    and lens, each visible K and V row read once."""
    nbytes = (2 * B * H * dh * itemsize + B * nb * 4 + B * 4
              + visible * K * dh * itemsize * 2)
    return 4 * H * dh * visible, nbytes


def paged_append_work(B, K, dh, rows, itemsize=2):
    """(operations, bytes) of one append of ``rows`` kept rows."""
    return 0, 2 * 2 * rows * K * dh * itemsize + 2 * B * 4


# ---------------------------------------------------------------------------
# the model's own counts
# ---------------------------------------------------------------------------
def layer_matmul_params(m: Dict, active: bool = True) -> int:
    """Weights one token multiplies in one layer: the attention
    projections and the FFN (``top_k`` experts with ``active``, all of
    them without), the router included."""
    d, H, K, dh, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                      m["head_dim"], m["d_ff"])
    attn = d * H * dh + 2 * d * K * dh + H * dh * d
    E = m["n_experts"]
    if not E:
        return attn + 3 * d * f
    return attn + d * E + (m["top_k"] if active else E) * 3 * d * f


def token_flops(m: Dict, visible: int, logits: bool) -> int:
    """Model FLOPs of one token that attends to ``visible`` positions
    (itself included) in every layer, with its logits row or not."""
    L, H, dh = m["n_layers"], m["n_heads"], m["head_dim"]
    f = L * (2 * layer_matmul_params(m) + 4 * H * dh * visible)
    if logits:
        f += 2 * m["d_model"] * m["vocab"]
    return f


def prefill_flops(m: Dict, n: int) -> int:
    """A standalone causal prefill of ``n`` tokens, logits at its last
    position."""
    L, H, dh = m["n_layers"], m["n_heads"], m["head_dim"]
    return (n * L * 2 * layer_matmul_params(m)
            + L * 4 * H * dh * visible_pairs(n, n, True, m["window"])
            + 2 * m["d_model"] * m["vocab"])


def round_bytes(m: Dict, rows: int, visible: int) -> float:
    """Bytes a decode round of ``rows`` live rows must move: every weight
    it touches read once, the rows' embeddings, each visible K and V row
    read once, the new K/V written, and the live rows' logits written in
    f32.  Of a sparse layer's experts it counts as many as ``rows`` picks
    of ``top_k`` touch on average under uniform routing,
    E (1 - (1 - top_k / E) ** rows): all but 0.2 % of 8 at 30 rows."""
    L, d, K, dh, V = (m["n_layers"], m["d_model"], m["n_kv_heads"],
                      m["head_dim"], m["vocab"])
    E = m["n_experts"]
    per_layer = float(layer_matmul_params(m, active=False))
    if E:
        touched = E * (1.0 - (1.0 - m["top_k"] / E) ** rows)
        per_layer -= (E - touched) * 3 * d * m["d_ff"]
    weights = 2 * (L * (per_layer + 2 * d) + d + d * V + rows * d)
    kv = 2 * 2 * K * dh * L * (visible + rows)
    return weights + kv + 4 * rows * V
