"""Device, closed loop: the mean time from ``process_packet``'s return to
the scan's pose on the host over the window (the card running the scan's
work, then the pose's copy back), the rest of each scan's latency, ms."""


def read(ctx):
    w = ctx["window"]
    lat, e = w.get("latency_s"), w.get("enqueue_s")
    if ctx["driver"] != "online" or not lat or len(lat) != len(e):
        return None
    return 1e3 * sum(a - b for a, b in zip(lat, e)) / len(lat)
