"""Device milliseconds a batch in the grouped probe's pool, the span
``ivf.pool`` (K1's candidates reassembled per pair, packed ids decoded, the
residual bias added, the pool top-k, dedup, dequantisation), per
``ivf.search`` call over the traced stretch."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "ivf.pool", "ivf.search", "device")
