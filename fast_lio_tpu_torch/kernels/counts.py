"""The kernels' launch counters as one set: read, restore and add.

Each wrapper adds one to its counter where it launches its kernel.  A CUDA
graph runs its captured launches at every replay without calling the
wrapper, so ``step_graph.StepGraphs`` takes what the capture added
(``since``), puts the counters back as they were (``restore``: recording a
launch is not running it), and adds that many at every replay (``add``).
"""
from __future__ import annotations

from typing import Dict, List

from . import knn, knn_grouped

Counts = List[Dict[int, int]]


def counters() -> Counts:
    """The live counter dicts, in a fixed order."""
    return [knn.launches, knn.launches_f64, knn_grouped.launches,
            knn_grouped.prep_launches]


def snapshot() -> Counts:
    return [dict(c) for c in counters()]


def since(before: Counts) -> Counts:
    """What each counter gained since ``before``."""
    return [{r: c[r] - b[r] for r in c} for c, b in zip(counters(), before)]


def restore(before: Counts) -> None:
    for c, b in zip(counters(), before):
        c.update(b)


def add(delta: Counts) -> None:
    for c, d in zip(counters(), delta):
        for r, n in d.items():
            c[r] += n


def total(delta: Counts) -> int:
    return sum(sum(d.values()) for d in delta)
