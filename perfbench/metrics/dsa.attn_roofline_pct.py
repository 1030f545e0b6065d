"""Sparse attention's share of its roofline: its least time for the work the
program counted over the traced stretch (``dsa.pairs`` selected pairs at 2
x 128 x (192 + 128) operations each, the non-absorbed form, at 989 TFLOP/s,
or the latent rows, queries and outputs of ``dsa.queries`` rows once at
3.35 TB/s, the larger; ``bounds_dsa.attn_least_s``), over the device time
of the ``dsa.attn`` spans.  An absorbed design does 3.4 times the counted
operations, so it reads at most about 29%."""

from perfbench import bounds_dsa


def read(rec: dict) -> float | None:
    if not rec.get("trace"):
        return None
    from lotus_tpu_torch import profiling

    counter_totals, span_totals = getattr(profiling, "counter_totals", None), getattr(profiling, "span_totals", None)
    if counter_totals is None or span_totals is None:
        return None
    counters, spans = counter_totals(), span_totals()
    if any(n not in counters for n in ("dsa.queries", "dsa.pairs")) or spans.dropped:
        return None
    if "dsa.attn" not in spans or spans["dsa.attn"].device_s <= 0:
        return None
    least = bounds_dsa.attn_least_s(rec["model"], float(counters["dsa.pairs"].sum()),
                                    float(counters["dsa.queries"].sum()))
    return 100.0 * least["s"] / spans["dsa.attn"].device_s
