"""Share of the traced window in which no kernel, copy or set ran on the
card, from the profiler's device activity (device layer)."""


def read(record):
    trace = record["trace"]
    if not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
