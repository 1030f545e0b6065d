"""The routed experts' share of their roofline: their least time for the
pairs routed over the traced stretch (``bounds_moe.experts_least_s``: 2 x 3 x
hidden x width a pair at 989 TFLOP/s, or each used expert's weights once a
layer call and each pair's row in and out at 3.35 TB/s, the larger), over
the device time of the ``moe.experts`` spans (the two grouped GEMMs, the
gather before them and the weighted combine after)."""

from perfbench import bounds_moe, moe_records


def read(rec: dict) -> float | None:
    got = moe_records.counters(rec)
    if got is None or "moe.experts" not in got["spans"] or got["spans"]["moe.experts"].device_s <= 0:
        return None
    least = bounds_moe.experts_least_s(rec["model"], float(got["moe.pairs"].sum()),
                                       float(got["moe.experts_used"].sum()))
    return 100.0 * least["s"] / got["spans"]["moe.experts"].device_s
