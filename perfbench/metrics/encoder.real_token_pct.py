"""Real tokens over the padded tokens the encoder was given, counted from
the attention masks of its forwards over the window before the traced
stretch."""


def read(rec: dict) -> float | None:
    pre = (rec.get("trace") or {}).get("pre") or {}
    if not pre.get("padded_tokens"):
        return None
    return 100.0 * pre["real_tokens"] / pre["padded_tokens"]
