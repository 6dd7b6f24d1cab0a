"""Packet API and feed: the median host time of one ``process_packet``
call while the host runs ahead of the device (sync, packing, the pinned
feed's copy, the graph's launch), less the time it waited for the feed's
ring (``PinnedFeed.take``, timed in a traced run), over the window, ms."""
import statistics


def read(ctx):
    w = ctx["window"]
    e, waits = w.get("enqueue_s", []), w.get("feed_wait_s", [])
    if ctx["driver"] != "replay" or not e or len(waits) != len(e):
        return None
    return 1e3 * statistics.median(a - b for a, b in zip(e, waits))
