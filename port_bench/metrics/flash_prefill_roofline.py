"""flash_prefill_roofline: the least time of the profiled prefills'
``flash_prefill`` calls (one a layer, at the length the engine pads the
prefill to; the frozen ``work.flash_prefill_work`` on the card's
published peaks) over that kernel's device time in the trace, in %."""
from port_bench import stats, work


def read(rec):
    if rec.trace is None:
        return None
    device = stats.kernel_seconds(rec, "flash_prefill_kernel")
    if not device:
        return None
    m = rec.m
    H, K, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    least = sum(m["n_layers"] * stats.least_seconds(rec, work.flash_prefill_work(
        1, kl, kl, H, K, dh, dh, causal=True, window=m["window"]))
        for _, kl, profiled in rec.prefills if profiled)
    return 100.0 * least / device
