"""paged_decode_roofline: the least time of the profiled rounds'
``paged_decode`` and ``paged_append`` calls (one each a layer; the
frozen ``work.paged_decode_work`` / ``paged_append_work`` on the card's
published peaks; an idle row reads the one position its length 1 gives
it) over those kernels' device time in the trace, in %."""
from port_bench import stats, work


def read(rec):
    if rec.trace is None:
        return None
    device = stats.kernel_seconds(rec, "paged_decode_kernel") \
        + stats.kernel_seconds(rec, "paged_append_kernel")
    if not device:
        return None
    m = rec.m
    B, L = rec.n_slots, m["n_layers"]
    H, K, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    least = 0.0
    for r in rec.rounds:
        if not r.profiled:
            continue
        visible = sum(pos + 1 for _, pos in r.rows) + B - len(r.rows)
        least += L * stats.least_seconds(rec, work.paged_decode_work(
            B, H, K, dh, rec.max_nb, visible))
        least += L * stats.least_seconds(rec, work.paged_append_work(
            B, K, dh, len(r.rows)))
    return 100.0 * least / device
