"""The passage join's share of the card's bf16 peak: DeepSeek-V2's model
operations over real tokens (``bounds_moe.dsv2_flops``: 2 x the parameters a
token reaches, 2 x heads x (nope + rope + v) a scored causal pair a layer)
over the seconds of the window before the traced stretch x 989 TFLOP/s."""

from perfbench import bounds


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("model_flops") or pre["seconds"] <= 0:
        return None
    return 100.0 * pre["model_flops"] / (pre["seconds"] * bounds.BF16_OPS_PER_S)
