"""launches_per_round: the kernels that ran in the profiled sub-window
(the prefills' included) over the decode rounds it held."""


def read(rec):
    if rec.trace is None:
        return None
    rounds = sum(r.profiled for r in rec.rounds)
    return rec.trace.launches / rounds if rounds else None
