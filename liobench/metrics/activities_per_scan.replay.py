"""Step graph: the device activities (kernels and copies) the profiler
saw in the profiled window, a scan."""
from liobench.readers import activities


def read(ctx):
    return activities(ctx, "replay")
