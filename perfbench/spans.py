"""The program's own spans (``lotus_tpu_torch.profiling``) as the per-layer
readers read them.  The program records spans only while a
``torch.profiler`` session runs; in a ``--trace 1`` run that is the traced
stretch alone, so the latest session is the stretch's calls."""

from __future__ import annotations


def per_call_ms(rec: dict, name: str, root: str, clock: str) -> float | None:
    """Milliseconds in span ``name`` per call of the root span ``root``
    over the traced stretch, on the device's clock (``clock="device"``: the
    span's CUDA events) or the host's (``"host"``).  None outside a traced
    run, where the session holds no such span (a program without them), or
    where it dropped spans past its cap."""
    if not rec.get("trace"):
        return None
    from lotus_tpu_torch import profiling

    span_totals = getattr(profiling, "span_totals", None)
    if span_totals is None:
        return None
    totals = span_totals()
    if totals.dropped or name not in totals or root not in totals or totals[root].roots <= 0:
        return None
    return 1e3 * getattr(totals[name], f"{clock}_s") / totals[root].roots
