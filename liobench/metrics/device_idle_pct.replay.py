"""Device: the share of the window's wall time in which the card had no
scan's work under way, %: 1 - the scans' device spans (CUDA events before
and after each ``process_packet`` in a traced run's window) over the
window's wall time."""
from liobench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "replay")
