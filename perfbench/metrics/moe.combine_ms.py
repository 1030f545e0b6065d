"""Device milliseconds a forward in the MoE layers' combine, the span
``moe.combine`` (each token's expert rows weighted and summed in f32 with
the shared experts' row, rounded once: K4 on the card), per ``rm.forward``
over the traced stretch.  None where the program has no such span."""

from perfbench import moe_records


def read(rec: dict) -> float | None:
    return moe_records.per_forward_ms(rec, "moe.combine")
