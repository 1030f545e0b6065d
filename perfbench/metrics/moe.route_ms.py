"""Device milliseconds a forward in the MoE layers' routing, the span
``moe.route`` (the gate in f32, softmax, top-k, the pairs' sort and offsets),
per ``rm.forward`` over the traced stretch."""

from perfbench import moe_records


def read(rec: dict) -> float | None:
    return moe_records.per_forward_ms(rec, "moe.route")
