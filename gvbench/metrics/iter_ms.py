"""Milliseconds per VAMP iteration: the spans around ``linear.infer``
over the iterations in the fits' histories (engine layer)."""


def read(record):
    spans = record["spans"].get("engine")
    iters = record["counters"].get("iterations", 0)
    return 1e3 * sum(spans) / iters if spans and iters else None
