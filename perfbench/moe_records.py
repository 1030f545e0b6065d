"""What the DeepSeek-V2 cell's readers take from the program after a traced
run: span device milliseconds per ``rm.forward`` and the MoE counters of
``lotus_tpu_torch.profiling``'s latest session (the traced stretch).  Each
is None outside a traced run or where the program has no such span or
counter (a program without them)."""

from __future__ import annotations


def _profiling(rec: dict):
    if not rec.get("trace"):
        return None
    from lotus_tpu_torch import profiling

    return profiling


def per_forward_ms(rec: dict, name: str) -> float | None:
    """Device milliseconds in span ``name`` per ``rm.forward`` span (one
    batch's forward), between the spans' CUDA events."""
    profiling = _profiling(rec)
    span_totals = getattr(profiling, "span_totals", None)
    if span_totals is None:
        return None
    totals = span_totals()
    if totals.dropped or name not in totals or totals.get("rm.forward") is None or totals["rm.forward"].calls <= 0:
        return None
    return 1e3 * totals[name].device_s / totals["rm.forward"].calls


def counters(rec: dict) -> dict | None:
    """The session's MoE counters (host tensors) and span totals, or None."""
    profiling = _profiling(rec)
    counter_totals = getattr(profiling, "counter_totals", None)
    if counter_totals is None:
        return None
    got = counter_totals()
    if "moe.pairs" not in got:
        return None
    return {**got, "spans": profiling.span_totals()}
