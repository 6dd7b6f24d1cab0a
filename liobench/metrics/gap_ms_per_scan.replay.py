"""Step graph: the window's wall time less its scans' device spans (CUDA
events before and after each ``process_packet`` in a traced run's window),
a scan, ms: how long the card waits between scans for the host."""
from liobench.readers import gap_ms


def read(ctx):
    return gap_ms(ctx, "replay")
