"""setup_s: wall seconds from the process's start to the window's: imports,
the kernels' build or load, the weights made on the card, the runtime,
and the warm-up until every slot has decoded."""


def read(rec):
    return rec.setup_s
