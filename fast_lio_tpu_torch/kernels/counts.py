"""The kernels' launch counters as one set: read, restore and add.

Each wrapper adds one to its counter where it launches its kernel.  A CUDA
graph runs its captured launches at every replay without calling the
wrapper, so ``step_graph.StepGraphs`` takes what the capture added
(``since``), puts the counters back as they were (``restore``: recording a
launch is not running it), and adds that many at every replay (``add``).

A launch recorded inside a CUDA-graph conditional node (``control_flow.gate``
in a gated capture) runs only on the replays whose predicate holds, so it
is counted on the device instead: the gate takes its body's launches off
the counters and records ``add_on_device`` of them inside the node.  Those
counts stay on the device until ``settle`` reads them into the counters (a
host read, made only when asked: ``StepGraphs.stats``, ``chip_smoke.py``,
the tests), never per scan.  A WHILE node's passes are counted by its
condition kernel itself, which adds one to the device counter of
``graph_if.while_launches[1]`` (``device_slot``) at the end of each pass.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import graph_if, knn, knn_grouped, segment_sum

Counts = List[Dict[int, int]]

SLOTS = 64  # (counter, key) pairs the device counters hold

_slots: Dict[Tuple[int, int], int] = {}  # (counter index, key) -> slot
_on_device: Dict[torch.device, torch.Tensor] = {}  # (SLOTS,) int64 each


def counters() -> Counts:
    """The live counter dicts, in a fixed order."""
    return [knn.launches, knn.launches_f64, knn.batched_launches,
            knn.batched_launches_f64, knn_grouped.launches,
            knn_grouped.prep_launches, graph_if.launches,
            graph_if.while_launches, segment_sum.launches,
            segment_sum.batched_launches, knn.cand_launches,
            knn.cand_launches_f64, knn.cand_batched_launches,
            knn.cand_batched_launches_f64]


NAMES = ("knn", "knn_f64", "knn_batched", "knn_batched_f64", "knn_grouped",
         "knn_grouped_prep", "graph_if", "graph_while", "segment_sum",
         "segment_sum_batched", "knn_cand", "knn_cand_f64",
         "knn_cand_batched", "knn_cand_batched_f64")  # counters()'s order


def named() -> Dict[str, Dict[int, int]]:
    """A copy of each counter by name (``graph_while``: key 0 the WHILE
    nodes entered, key 1 the passes run)."""
    return {n: dict(c) for n, c in zip(NAMES, counters())}


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


def _key(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_counter(device) -> torch.Tensor:
    """The device counters of ``device``, made at first use.  Make them
    before a capture: a tensor made inside one would be zeroed at every
    replay."""
    device = _key(device)
    if device not in _on_device:
        _on_device[device] = torch.zeros(SLOTS, dtype=torch.int64,
                                         device=device)
    return _on_device[device]


def _slot(i: int, key: int) -> int:
    """The device counters' slot of key ``key`` of counter ``i``."""
    slot = _slots.setdefault((i, key), len(_slots))
    if slot >= SLOTS:
        raise RuntimeError("out of device counter slots")
    return slot


def _on(device) -> torch.Tensor:
    dev = _on_device.get(_key(device))
    if dev is None:
        raise RuntimeError(f"no device counters on {device}: call "
                           "device_counter before the capture")
    return dev


def device_slot(counter: Dict[int, int], key: int, device) -> torch.Tensor:
    """The one-element device counter that ``settle`` adds to
    ``counter[key]`` (a view of ``device``'s counters), for a kernel that
    counts its own launches as it runs."""
    i = [id(c) for c in counters()].index(id(counter))
    slot = _slot(i, key)
    return _on(device)[slot:slot + 1]


def add_on_device(delta: Counts, device) -> None:
    """Add ``delta`` to ``device``'s counters with device work (one small
    add a counted key), which a graph records where it is called."""
    if not total(delta):  # the plain versions (the CPU) launch nothing
        return
    dev = _on(device)
    for i, d in enumerate(delta):
        for r, n in d.items():
            if n:
                slot = _slot(i, r)
                dev[slot:slot + 1].add_(n)


def settle() -> None:
    """Read every device's counters into the counters and zero them (a
    host read)."""
    live = counters()
    for dev in _on_device.values():
        vals = dev.tolist()
        for (i, r), slot in _slots.items():
            live[i][r] += vals[slot]
        dev.zero_()
