"""Host milliseconds a store call before its first launch, the span
``vs.inputs`` (the queries to an f32 array and to the card, an ids search's
ids to an int64 array and to the card), per ``vs.call`` call over the
traced stretch: host time in which a closed loop's card has nothing queued."""

from perfbench import spans


def read(rec: dict) -> float | None:
    return spans.per_call_ms(rec, "vs.inputs", "vs.call", "host")
