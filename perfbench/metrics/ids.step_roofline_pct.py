"""The ids search step's share of its roofline: the least time a batch
needs, whatever implements it, times the batches of the window before the
traced stretch, over that part's seconds (the profiler not yet started).
A batch reads the allowed rows once (int8 and a scale) at HBM's rate and
does 2 * d f32 operations for each (query, allowed row) pair at the f32
rate; its least time is the larger of the two."""

from perfbench import bounds


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("steps") or pre["seconds"] <= 0 or not rec.get("ids_rows"):
        return None
    m, b, d = rec["ids_rows"], rec["batch"], rec["d"]
    least = max(m * (d + 4) / bounds.HBM_BYTES_PER_S, 2.0 * b * m * d / bounds.F32_OPS_PER_S)
    return 100.0 * least * pre["steps"] / pre["seconds"]
