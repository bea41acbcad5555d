"""round_hbm_share: the bytes the window's decode rounds must move
(``work.round_bytes``: weights touched, visible KV, the new KV, logits)
over their walls times the card's published HBM rate, in %.  Rounds in
the profiled sub-window are left out (the profiler slows them); a traced
run synchronises after each admission, so a round's wall holds its own
work alone."""
from port_bench import work


def read(rec):
    rounds = [r for r in rec.window_rounds() if not r.profiled]
    if not rounds:
        return None
    nbytes = sum(work.round_bytes(rec.m, len(r.rows),
                                  sum(pos + 1 for _, pos in r.rows))
                 for r in rounds)
    wall = sum(r.t_end - r.t_call for r in rounds)
    return 100.0 * nbytes / (wall * rec.peaks["hbm_bytes_per_s"])
