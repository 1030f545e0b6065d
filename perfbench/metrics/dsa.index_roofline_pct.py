"""The lightning indexer's share of its roofline: its least time for the
work the program counted over the traced stretch (``dsa.scored`` causal
pairs at 2 x 64 x 128 operations each and 989 TFLOP/s, or the index
queries, keys, head weights and selection of ``dsa.queries`` rows and
``dsa.pairs`` pairs once at 3.35 TB/s, the larger; ``bounds_dsa.index_least_s``),
over the device time of the ``dsa.index`` spans.  It reads the same work
whatever implements the indexer."""

from perfbench import bounds_dsa


def read(rec: dict) -> float | None:
    if not rec.get("trace"):
        return None
    from lotus_tpu_torch import profiling

    counter_totals, span_totals = getattr(profiling, "counter_totals", None), getattr(profiling, "span_totals", None)
    if counter_totals is None or span_totals is None:
        return None
    counters, spans = counter_totals(), span_totals()
    if any(n not in counters for n in ("dsa.scored", "dsa.queries", "dsa.pairs")) or spans.dropped:
        return None
    if "dsa.index" not in spans or spans["dsa.index"].device_s <= 0:
        return None
    least = bounds_dsa.index_least_s(rec["model"], float(counters["dsa.scored"].sum()),
                                     float(counters["dsa.queries"].sum()), float(counters["dsa.pairs"].sum()))
    return 100.0 * least["s"] / spans["dsa.index"].device_s
