"""Device milliseconds a forward in KDA linear attention, the span
``kda.attn`` (each KDA layer's norm, projections, convolutions, gates,
recurrence, gated norm and output projection), per ``rm.forward`` over the
traced stretch."""

from perfbench import moe_records


def read(rec: dict) -> float | None:
    return moe_records.per_forward_ms(rec, "kda.attn")
