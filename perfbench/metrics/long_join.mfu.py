"""The long-document join's share of the card's bf16 peak: Kimi-Linear's
model operations over real tokens (``bounds_kda.kimi_flops``: 2 x the
non-routed parameters a token reaches and the held share of its routed
experts, latent attention's scored causal pairs, KDA's recurrence a (token,
head)) over the seconds of the window before the traced stretch x 989
TFLOP/s."""

from perfbench import bounds


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("model_flops") or pre["seconds"] <= 0:
        return None
    return 100.0 * pre["model_flops"] / (pre["seconds"] * bounds.BF16_OPS_PER_S)
