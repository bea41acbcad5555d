"""batch_rows_mean: live rows per decode round, the mean over the window's
rounds."""


def read(rec):
    rounds = rec.window_rounds()
    return sum(len(r.rows) for r in rounds) / len(rounds) if rounds else None
