"""Host syncs per VAMP iteration: the change of the program's exact
counter ``sync.SYNCS`` over the fits, per iteration (engine layer)."""


def read(record):
    iters = record["counters"].get("iterations", 0)
    if not iters or "host_syncs" not in record["counters"]:
        return None
    return record["counters"]["host_syncs"] / iters
