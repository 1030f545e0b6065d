"""Device milliseconds a batch in the grouped probe's coarse ranking, the
span ``ivf.coarse`` (``flat_search`` over the centroids: each slice's probed
lists and residual bias), per ``ivf.search`` call over the traced stretch."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "ivf.coarse", "ivf.search", "device")
