"""Share of their roofline that the packed-matrix products' kernels
reached in the window: the sum over the calls of each call's least time
(``yardstick.least_seconds``: the words read once and each f32 column in
and out once at the HBM rate, against 2 N M B operations at the int8
rate) over the sum of their kernels' device time, each call paired in
order with its product's kernel (kernels layer)."""

from gvbench.yardstick import least_seconds


def read(record):
    pairs = record["trace"]["product_s"]
    if not pairs:
        return None
    least = sum(least_seconds(*call) for call, _ in pairs)
    spent = sum(t for _, t in pairs)
    return 100.0 * least / spent if spent > 0 else None
