"""itl_ms_p99: the 99th percentile of every gap between consecutive tokens
of a step inside the window (``stats.itl_gaps``), in ms: the tail a user
feels when an admission's prefill stalls the batch (the 95th sits on the
edge of those stalls, which are ~5 % of the gaps)."""
from port_bench import stats


def read(rec):
    gaps = stats.itl_gaps(rec)
    return 1e3 * stats.percentile(gaps, 99) if gaps else None
