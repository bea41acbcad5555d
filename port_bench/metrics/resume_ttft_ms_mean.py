"""resume_ttft_ms_mean: for each resumed step (a session's second or later
admission) admitted inside the window, the wall from its
``start_session`` call to the end of the round that returned its first
token; the mean over all of them whose first token came in the window,
in ms."""
from port_bench import stats


def read(rec):
    ttft = [s.times[0] - s.t_call for s in rec.window_steps()
            if s.kind != "first" and s.times
            and stats.in_window(rec, s.times[0])]
    return 1e3 * sum(ttft) / len(ttft) if ttft else None
