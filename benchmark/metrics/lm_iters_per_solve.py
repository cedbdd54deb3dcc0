"""LM iterations per solve (``BASummary.num_iterations``), mean over the
traced slice's solves."""


def read(sl):
    solves = [u for u in sl.units if "iters" in u]
    return sum(u["iters"] for u in solves) / len(solves) if solves else None
