"""kNN: the search kernels' share of their roofline, %: the least time of
their launches' work (``roofline.knn_work``: the distinct map rows, the
queries and results at the HBM rate, or the candidates' operations at the
float32 rate, whichever is longer) over the device time of the kernels
named ``knn_...kernel<type, R>``, in the profiled window."""
from liobench.readers import knn_pct


def read(ctx):
    return knn_pct(ctx, "replay")
