"""The 95th percentile, over every scan of the window, of the time from the
packet handed to ``process_packet`` to its pose read on the host (the next
packet waits for it), ms."""
import numpy as np


def read(ctx):
    lat = ctx["window"].get("latency_s", [])
    if ctx["driver"] != "online" or not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
