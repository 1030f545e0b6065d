"""The join step's share of the card's bf16 peak: the encoder's model
operations over real tokens (``bounds.bert_flops``: 2 x
non-embedding parameters a token, 4 * L * h a scored pair) over the seconds
of the window before the traced stretch x 989 TFLOP/s."""

from perfbench import bounds


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("model_flops") or pre["seconds"] <= 0:
        return None
    return 100.0 * pre["model_flops"] / (pre["seconds"] * bounds.BF16_OPS_PER_S)
