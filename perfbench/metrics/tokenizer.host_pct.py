"""The tokenizer's share of the window: host seconds inside the RM's
``tokenizer.encode`` (wrapped by the benchmark) over the seconds of the
window before the traced stretch (the profiler not yet started)."""


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if pre.get("tokenize_s") is None or pre["seconds"] <= 0:
        return None
    return 100.0 * pre["tokenize_s"] / pre["seconds"]
