"""Device milliseconds a batch in the grouped probe's exact rescore, the
span ``ivf.rescore`` (``rescore_candidates`` over the rebuilt candidate rows
and ``as_distance``), per ``ivf.search`` call over the traced stretch."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "ivf.rescore", "ivf.search", "device")
