"""Device milliseconds a forward in latent attention, the span ``mla.attn``
(each layer's norm, projections, rope, attention and output projection), per
``rm.forward`` over the traced stretch."""

from perfbench import moe_records


def read(rec: dict) -> float | None:
    return moe_records.per_forward_ms(rec, "mla.attn")
