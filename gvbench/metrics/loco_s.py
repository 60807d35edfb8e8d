"""Seconds of the LOCO p-values per trait: the span around
``ops.pvals.loco_pvals`` (p-value layer); None in a mix without them."""


def read(record):
    spans = record["spans"].get("pvals")
    return sum(spans) / len(spans) if spans else None
