"""Device milliseconds a batch in the ids search's row gather, the span
``ivf.subset_rows`` (the allowed rows found through the inverse permutation
and rebuilt in f32), per ``vs.call`` call over the traced stretch."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "ivf.subset_rows", "vs.call", "device")
