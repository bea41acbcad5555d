"""itl_ms_p99.host: ``itl_ms_p99`` read in the traced run of a cell where
the host sets the pace (the card idle over half of the traced window),
where the tail of host-clock gaps spreads too widely to bound."""
from port_bench import stats


def read(rec):
    gaps = stats.itl_gaps(rec)
    return 1e3 * stats.percentile(gaps, 99) if gaps else None
