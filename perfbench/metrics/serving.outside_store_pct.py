"""The serving tier's share of the latency: of all requests' latency over
the window (each from when it was due), the part outside the server's store
calls (queueing, frames, loopback, the front end's merge).  Host clocks: the
load generator's, and the server's around each store call."""


def read(rec: dict) -> float | None:
    served = rec.get("served")
    if not served or served["latency_sum_s"] <= 0:
        return None
    return 100.0 * (1.0 - served["store_sum_s"] / served["latency_sum_s"])
