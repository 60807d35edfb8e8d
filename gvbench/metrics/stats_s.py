"""Seconds of the statistics pass per trait: the span around
``GenoBed.set_phen`` (data layer)."""


def read(record):
    spans = record["spans"].get("data")
    return sum(spans) / len(spans) if spans else None
