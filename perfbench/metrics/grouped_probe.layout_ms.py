"""Device milliseconds a batch in the grouped probe's layout, the span
``ivf.layout`` (the queries' int8 quantisation and ``probe_layout``: pair
grouping, chunk table, padded query units), per ``ivf.search`` call over
the traced stretch."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "ivf.layout", "ivf.search", "device")
