"""The KDA recurrence's share of its roofline: its least time for the
(token, head) pairs the program counted over the traced stretch
(``kda.tokens``; ``bounds_kda.scan_least_s``: q, k, v and o in bf16, g and
beta in f32, each once at 3.35 TB/s, or 7 d^2 operations a pair at 989
TFLOP/s, the larger), over the device time of the ``kda.scan`` spans.  It
reads the same work whatever implements the recurrence."""

from perfbench import bounds_kda


def read(rec: dict) -> float | None:
    if not rec.get("trace"):
        return None
    from lotus_tpu_torch import profiling

    counter_totals, span_totals = getattr(profiling, "counter_totals", None), getattr(profiling, "span_totals", None)
    if counter_totals is None or span_totals is None:
        return None
    tokens, spans = counter_totals().get("kda.tokens"), span_totals()
    if tokens is None or spans.dropped or "kda.scan" not in spans or spans["kda.scan"].device_s <= 0:
        return None
    least = bounds_kda.scan_least_s(rec["model"], float(tokens.sum()))
    return 100.0 * least["s"] / spans["kda.scan"].device_s
