"""serve_mfu: model FLOPs of every token prefilled and decoded in the
profiled sub-window (``work.prefill_flops`` / ``work.token_flops``: a
sparse layer at its experts per token), over the sub-window's wall times
the card's published bf16 peak, in %."""
from port_bench import work


def read(rec):
    if rec.trace is None:
        return None
    m = rec.m
    flops = sum(work.token_flops(m, pos + 1, True)
                for r in rec.rounds if r.profiled for _, pos in r.rows)
    flops += sum(work.prefill_flops(m, n)
                 for n, _, profiled in rec.prefills if profiled)
    return 100.0 * flops / (rec.trace.window_s * rec.peaks["bf16_flops"])
