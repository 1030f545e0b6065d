"""The whole-document join's share of the card's bf16 peak: DeepSeek-V3.2's
model operations over real tokens (``bounds_dsa.dsv32_flops``: 2 x the
parameters a token reaches, the routed experts at the held share of its
pairs, the indexer's scored causal pairs and attention's selected pairs)
over the seconds of the window before the traced stretch x 989 TFLOP/s."""

from perfbench import bounds


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("model_flops") or pre["seconds"] <= 0:
        return None
    return 100.0 * pre["model_flops"] / (pre["seconds"] * bounds.BF16_OPS_PER_S)
