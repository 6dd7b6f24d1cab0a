"""The per-scan step captured in CUDA graphs, one per pad bucket, and the
pinned host buffers that feed it.

The counterpart of ``jax.jit(packed)`` in the JAX package's ``Pipeline``
(``fast_lio_tpu/pipeline.py:526-566``): one compile per input shape there,
one capture per pad bucket here.  The step (``Pipeline._packed_step``)
reads nothing on the host, so it records whole.  At the first scan of a
bucket it runs eagerly on a side stream: that is the scan's result, and the
warm-up that builds and configures the kNN kernels and makes the step's
device constants before anything is recorded.  Then it is captured into a
``torch.cuda.CUDAGraph`` that reads one static device buffer.  Every later
scan of the bucket is one copy from a pinned host buffer into it and one
replay.  A capture that fails raises; nothing falls back to the eager step.

The graph's outputs are static tensors that the next replay overwrites, so
``Pipeline`` copies what it keeps (on the device, with no sync).  The kernel
launch counters count at Python call time, so each graph records how many
launches of each kernel it holds and every replay adds them
(``kernels.counts``).
"""
from __future__ import annotations

import collections
import gc
from typing import Callable, Dict, NamedTuple

import torch

from .kernels import counts


class _Slot:
    """One pinned host buffer and the event that marks the device's copy
    of it done."""

    def __init__(self, n: int):
        self.buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.event = None


class PinnedFeed:
    """Pinned host buffers the scans are packed into, ``SLOTS`` of each
    length in a ring.  The device copies a buffer out asynchronously, so a
    buffer is written again only after that copy has run: an event per
    buffer, which the host waits on only when it runs ``SLOTS`` scans ahead
    of the device (``waits`` counts those waits)."""

    SLOTS = 4

    def __init__(self):
        self._rings: Dict[int, list] = {}
        self._next: Dict[int, int] = collections.Counter()
        self._taken = None  # the slot the scan in flight was packed into
        self.waits = 0

    def take(self, n: int) -> torch.Tensor:
        """A pinned float32 buffer of ``n`` floats that no pending copy
        reads."""
        ring = self._rings.get(n)
        if ring is None:
            ring = self._rings[n] = [_Slot(n) for _ in range(self.SLOTS)]
        k = self._next[n]
        self._next[n] = (k + 1) % self.SLOTS
        slot = ring[k]
        if slot.event is not None and not slot.event.query():
            slot.event.synchronize()
            self.waits += 1
        self._taken = slot
        return slot.buf

    def copied(self) -> None:
        """The buffer of the last ``take`` has been handed to the device on
        the current stream: mark where its copy ends."""
        slot, self._taken = self._taken, None
        if slot.event is None:
            slot.event = torch.cuda.Event()
        slot.event.record()


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: dict
    launches: counts.Counts  # kernel launches one replay makes


class StepGraphs:
    """A step (a device buffer -> a dict of tensors, with no host read)
    captured once per buffer length on ``device`` and replayed.  The step
    is passed at each call, not kept: a pipeline that holds its graphs and
    is held by them would be freed only by the garbage collector."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[int, _Captured] = {}
        self.replays: Dict[int, int] = collections.Counter()

    def run(self, host: torch.Tensor,
            step: Callable[[torch.Tensor], dict]) -> dict:
        """Run ``step`` on the scan in ``host`` (a pinned buffer): a replay,
        or for a new length the eager step and then the capture.  Returns
        the outputs, which the next scan of the length overwrites (a
        replay's are the graph's static tensors)."""
        n = host.shape[0]
        cap = self._graphs.get(n)
        if cap is None:
            return self._run_and_capture(host, step)
        cap.static_in.copy_(host, non_blocking=True)
        cap.graph.replay()
        counts.add(cap.launches)
        self.replays[n] += 1
        return cap.static_out

    def _run_and_capture(self, host: torch.Tensor, step) -> dict:
        n = host.shape[0]
        static_in = torch.empty(host.shape, dtype=host.dtype,
                                device=self.device)
        static_in.copy_(host, non_blocking=True)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = step(static_in)  # this scan, and the warm-up
        main.wait_stream(side)
        for v in out.values():  # used on the main stream from here on
            v.record_stream(main)
        before = counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        # a graph that the collector frees while this one records (another
        # pipeline's, say, in a reference cycle) ends the capture with an
        # error: collect first, and not during the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                static_out = step(static_in)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the step for a feed of {n} floats failed: {e}"
            ) from e
        finally:
            if collecting:
                gc.enable()
            launches = counts.since(before)
            counts.restore(before)
        self._graphs[n] = _Captured(graph, static_in, static_out, launches)
        return out

    def stats(self) -> dict:
        """Per captured feed length: replays so far and the kernel launches
        one replay makes."""
        return {n: {"replays": self.replays[n],
                    "launches_per_replay": counts.total(c.launches)}
                for n, c in self._graphs.items()}
