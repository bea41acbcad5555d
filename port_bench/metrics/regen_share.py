"""regen_share: of the prefill tokens of the resumed steps admitted in the
window, the share that regenerated a context whose KV had been evicted
(the harness reads ``engine.pool.has`` before each admission, so a
session's first admission never counts), in %."""


def read(rec):
    resumed = [s for s in rec.window_steps() if s.kind != "first"]
    total = sum(s.prefill for s in resumed)
    if not total:
        return None
    return 100.0 * sum(s.prefill for s in resumed
                       if s.kind == "regen") / total
