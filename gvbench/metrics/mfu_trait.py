"""The traced window's share of the card's peak (``mfu.trait``): the
least time of the work the trait needed there, over the window.  That
work is every traced packed-matrix product call
(``yardstick.least_seconds``) and one read of the words per statistics
pass, at the HBM rate.  A product taken off the path leaves its own
roofline silent; this share still bounds a claim (kernels layer, the
whole traced trait; the p-values lie outside the traced window)."""

from gvbench.yardstick import HBM_BYTES_PER_S, least_seconds


def read(record):
    window = record["trace"]["window_s"]
    if not window or not record["calls"]:
        return None
    least = sum(least_seconds(*call) for call in record["calls"])
    _, nw, mpad = record["calls"][0][:3]
    least += len(record["spans"].get("data", [])) * 4.0 * nw * mpad \
        / HBM_BYTES_PER_S
    return 100.0 * least / window
