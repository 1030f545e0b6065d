"""The routed experts' load imbalance over the traced stretch: per MoE
layer, the most-loaded expert's pairs summed over the layer's calls
(``moe.pairs_max``) over the mean expert's (the layer's pairs / experts),
averaged over the layers."""

from perfbench import moe_records


def read(rec: dict) -> float | None:
    got = moe_records.counters(rec)
    if got is None:
        return None
    pairs, top = got["moe.pairs"].double(), got["moe.pairs_max"][:, 0].double()
    live = pairs.sum(dim=1) > 0
    if not live.any():
        return None
    mean = pairs[live].sum(dim=1) / pairs.shape[1]
    return float((top[live] / mean).mean())
