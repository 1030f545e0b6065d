"""Device milliseconds a batch in every kernel of the grouped probe's path
but K1 (coarse ranking, layout, reassembly, pool top-k, rescore), over the
traced stretch; copies to and from the host are left out."""

K1 = ("probe_wgmma", "probe_cores")


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if not tr or not rec.get("k1_launches") or tr["steps"] <= 0:
        return None
    other = sum(dur for name, _, dur in tr["device_ops"]
                if not any(k in name for k in K1) and not name.startswith(("Memcpy", "Memset")))
    return 1e3 * other / tr["steps"]
