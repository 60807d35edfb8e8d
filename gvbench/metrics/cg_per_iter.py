"""CG iterations per VAMP iteration: the sum of ``cg_iters`` over the
fits' histories, per iteration (solver layer)."""


def read(record):
    iters = record["counters"].get("iterations", 0)
    if not iters or "cg_iters" not in record["counters"]:
        return None
    return record["counters"]["cg_iters"] / iters
