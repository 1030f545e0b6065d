"""K1's share of its roofline (``csrc/ivf_probe.cu`` through ``probe_fold``):
the least time of every K1 launch in the traced stretch (``bounds.k1_bound``
on each launch's inputs) over K1's device time there."""

from perfbench import bounds

K1 = ("probe_wgmma", "probe_cores")


def read(rec: dict) -> float | None:
    tr, launches = rec.get("trace"), rec.get("k1_launches")
    if not tr or not launches:
        return None
    device_s = sum(dur for name, _, dur in tr["device_ops"] if any(k in name for k in K1))
    if device_s <= 0:
        return None
    return 100.0 * sum(bounds.k1_bound(**launch)["s"] for launch in launches) / device_s
