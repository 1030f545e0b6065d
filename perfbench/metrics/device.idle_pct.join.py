"""The device's idle share over the traced stretch: 100 x (1 - the union
of its operations' intervals / the stretch's seconds)."""


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
