"""out_tokens_per_s: decoded tokens the window's rounds emitted, over the
window's wall seconds."""


def read(rec):
    t0, t1 = rec.t_window
    return sum(len(r.rows) for r in rec.window_rounds()) / (t1 - t0)
