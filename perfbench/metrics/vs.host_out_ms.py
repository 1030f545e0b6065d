"""Host milliseconds a store call after its answers reach the host, the span
``vs.to_lists`` (f64 and int64 arrays, padding, the store's stats,
``.tolist()``), per ``vs.call`` call over the traced stretch: host time in
which a closed loop's card has nothing queued."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "vs.to_lists", "vs.call", "host")
