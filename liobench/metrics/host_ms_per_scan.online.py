"""Packet API and feed, closed loop: the mean host time of a
``process_packet`` call over the window (sync, packing, the pinned feed's
copy, the graph's launch), the host's part of each scan's latency, ms."""


def read(ctx):
    e = ctx["window"].get("enqueue_s")
    if ctx["driver"] != "online" or not e:
        return None
    return 1e3 * sum(e) / len(e)
