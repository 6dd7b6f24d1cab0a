"""Downsample: the segmented mean's share of its roofline, %: the least
time of each call's work at the cell's shapes (``roofline.
segment_mean_work``: bytes at the HBM rate, operations at the float32 rate,
or the longest voxel's chain of adds) over the device time of the kernels
named ``segment_mean...kernel``, in the profiled window."""
from liobench.readers import downsample_pct


def read(ctx):
    return downsample_pct(ctx, "replay")
