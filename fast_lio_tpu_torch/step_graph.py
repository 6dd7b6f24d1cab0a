"""The per-scan step captured in CUDA graphs, one per pad bucket, and the
pinned host buffers that feed it.

The counterpart of ``jax.jit(packed)`` in the JAX package's ``Pipeline``
(``fast_lio_tpu/pipeline.py:526-566``): one compile per input shape there,
one capture per pad bucket here.  The step (``Pipeline._packed_step``, or
``BatchPipeline``'s vmapped step over a (B, L) buffer of B lanes, one graph
for the whole fleet) reads nothing on the host, so it records whole.  At the first scan of a
bucket it runs eagerly on a side stream: that is the scan's result, and the
warm-up that builds and configures the kNN kernels and makes the step's
device constants before anything is recorded.  Then it is captured into a
``torch.cuda.CUDAGraph`` that reads one static device buffer.  Every later
scan of the bucket is one copy from a pinned host buffer into it and one
replay.  A capture that fails raises; nothing falls back to the eager step.

Every step is captured with gates (``gates=True``,
``control_flow.gated_capture``): JAX's ``lax.cond`` arms are recorded as
CUDA-graph conditional IF nodes and its ``lax.while_loop`` as one WHILE
node, so a replay skips what JAX skips.  In the batch
(``torch.func.vmap``) a predicate that differs from lane to lane stays a
select, as JAX's ``lax.cond`` under ``vmap`` does, and the filter's passes
run while any lane is active (``control_flow.while_loop``); on NCCL ranks
every predicate is replicated, so every rank runs or skips each
conditional node's collectives with its peers.

The graph's outputs are static tensors that the next replay overwrites, so
``Pipeline`` copies what it keeps (on the device, with no sync).  The kernel
launch counters count at Python call time, so each graph records how many
launches of each kernel it holds outside any conditional node and every
replay adds them (``kernels.counts``), per rank on a sharded map; the
launches inside conditional nodes are counted on the device as they run
(``counts.add_on_device``).  ``stats`` gives each bucket's capture
seconds (the ``capture`` span of ``tracing``: the eager first step, the
capture and the graph's instantiation, ending synced) and the bytes the
conditional nodes' body pools (``kernels.graph_if``) grew by in it.  With
the tracer on, a replay is a ``launch`` span (the feed's copy enqueued and
the graph launched) and a wait for the feed a ``feed_wait`` span.

A sharded step (``parallel/sharding.py``, the counterpart of
``jax.jit(shard_map(...))``) is captured the same way on every NCCL rank,
with its collectives in the graph: every rank sees the same packets, so
every rank captures the same bucket at the same scan and replays in step
with the others.  Before a rank captures, one eager all-gather of the feed
shape checks that every rank is about to capture the same one.  The
warm-up runs each collective once before the capture, so the communicator
exists by then.  NCCL runs with graph mixing support off, so a replay and
an eager collective of the group are never outstanding together: the
group drains the card where one follows the other
(``ShardGroup.launching``: at a new bucket after replays, before its
capture, and before an eager gather such as ``health_check``'s), never
between two replays.  gloo's collectives copy through the host and cannot be
captured (``captures_by_default``).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from . import control_flow, tracing
from .kernels import counts, graph_if

Shape = Union[int, Tuple[int, ...]]  # a feed buffer's length, or (B, L)


def _shape(t: torch.Tensor) -> Shape:
    return t.shape[0] if t.dim() == 1 else tuple(t.shape)


class _Slot:
    """One pinned host buffer and the event that marks the device's copy
    of it done."""

    def __init__(self, shape: Shape):
        self.buf = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        self.event = None


class PinnedFeed:
    """Pinned host buffers the scans are packed into, ``SLOTS`` of each
    shape in a ring.  The device copies a buffer out asynchronously, so a
    buffer is written again only after that copy has run: an event per
    buffer, which the host waits on only when it runs ``SLOTS`` scans ahead
    of the device (``waits``)."""

    SLOTS = 4

    def __init__(self):
        self._rings: Dict[Shape, list] = {}
        self._next: Dict[Shape, int] = collections.Counter()
        self._taken = None  # the slot the scan in flight was packed into
        self._waits0 = tracing.counters["feed_waits"]

    @property
    def waits(self) -> int:
        """The waits for a slot since the feed was made: the process's
        ``feed_waits`` counter (every feed's, where several run at once)."""
        return tracing.counters["feed_waits"] - self._waits0

    def take(self, shape: Shape) -> torch.Tensor:
        """A pinned float32 buffer of ``shape`` (a length, or (B, L) for a
        batch) that no pending copy reads."""
        ring = self._rings.get(shape)
        if ring is None:
            ring = self._rings[shape] = [_Slot(shape)
                                         for _ in range(self.SLOTS)]
        k = self._next[shape]
        self._next[shape] = (k + 1) % self.SLOTS
        slot = ring[k]
        if slot.event is not None and not slot.event.query():
            sp = tracing.begin("feed_wait") if tracing.ON else None
            slot.event.synchronize()
            if sp is not None:
                tracing.end(sp)
            tracing.counters["feed_waits"] += 1
        self._taken = slot
        return slot.buf

    def copied(self) -> None:
        """The buffer of the last ``take`` has been handed to the device on
        the current stream: mark where its copy ends."""
        slot, self._taken = self._taken, None
        if slot.event is None:
            slot.event = torch.cuda.Event()
        slot.event.record()


def captures_by_default(device, group=None) -> bool:
    """Whether a pipeline on ``device`` (sharded over ``group``'s ranks, if
    given) captures its step when the caller does not say: on CUDA, alone
    or on NCCL ranks (``ShardGroup.capturable``); never on the CPU, nor on
    gloo ranks."""
    return (torch.device(device).type == "cuda"
            and (group is None or group.capturable))


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: dict
    launches: counts.Counts  # kernel launches a replay makes outside IFs
    capture_s: float  # the capture span: eager step, capture, instantiation
    body_pool_bytes: int  # what the body pools grew by in the capture


class StepGraphs:
    """A step (a device buffer -> a dict of tensors, with no host read)
    captured once per buffer shape on ``device`` and replayed.  The step
    is passed at each call, not kept: a pipeline that holds its graphs and
    is held by them would be freed only by the garbage collector.

    ``group`` (a ``parallel.ShardGroup`` on NCCL): the step's collectives
    run over it; every rank of it must run the same scans.

    ``gates`` (the default): capture inside ``control_flow.gated_capture``,
    so that the step's ``control_flow.gate``s record IF nodes; with a
    group, its collectives inside them (NCCL: ``group.capturable``).
    ``gates=False`` captures every gate masked: the reference that
    ``chip_smoke.py`` and the card tests hold the gated graph to."""

    def __init__(self, device: torch.device, group=None, gates=True):
        if gates and group is not None and not group.capturable:
            raise ValueError(
                f"a {group.backend} group's collectives cannot be recorded "
                "in a CUDA graph, nor in its IF nodes")
        self.device = torch.device(device)
        self.group = group
        self.gates = gates
        self._graphs: Dict[Shape, _Captured] = {}
        self.replays: Dict[Shape, int] = collections.Counter()

    def run(self, host: torch.Tensor,
            step: Callable[[torch.Tensor], dict]) -> dict:
        """Run ``step`` on the scan in ``host`` (a pinned buffer): a replay,
        or for a new shape the eager step and then the capture.  Returns
        the outputs, which the next scan of the shape overwrites (a
        replay's are the graph's static tensors)."""
        n = _shape(host)
        cap = self._graphs.get(n)
        if cap is None:
            return self._run_and_capture(host, step)
        sp = tracing.begin("launch") if tracing.ON else None
        cap.static_in.copy_(host, non_blocking=True)
        if self.group is not None:
            self.group.launching("graph")
        cap.graph.replay()
        if sp is not None:
            tracing.end(sp)
        counts.add(cap.launches)
        self.replays[n] += 1
        return cap.static_out

    def _same_shape_on_every_rank(self, n: Shape) -> None:
        """Raise unless every rank of the group is about to capture a feed
        of shape ``n``: one eager all-gather (after the group drains any
        replay: ``ShardGroup.launching``) and a host read, once a
        bucket."""
        dims = n if isinstance(n, tuple) else (n,)
        mine = torch.tensor((len(dims), *dims, *(0,) * (2 - len(dims))),
                            dtype=torch.int64, device=self.device)
        seen = self.group.all_gather(mine)
        if not bool((seen == mine).all()):
            raise RuntimeError(
                f"rank {self.group.rank} is about to capture the step for a "
                f"feed of shape {n}, and the ranks' (ndim, dims) are "
                f"{seen.tolist()}: every rank must run the same scans")

    def _run_and_capture(self, host: torch.Tensor, step) -> dict:
        n = _shape(host)
        t0 = time.time_ns()
        sp = tracing.begin("capture", t0, shape=n) if tracing.ON else None
        tracing.note_capture()
        if self.group is not None:
            self._same_shape_on_every_rank(n)
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
        if self.gates:
            counts.device_counter(self.device)  # made outside the graph
        if self.group is not None:  # the warm-up's eager collectives
            self.group.launching("graph")
        before = counts.snapshot()
        pool_bytes = graph_if.body_pool_bytes(self.device)
        graph = torch.cuda.CUDAGraph()
        # a graph that the collector frees while this one records (another
        # pipeline's, say, in a reference cycle) ends the capture with an
        # error: collect first, and not during the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        gated = (control_flow.gated_capture(self.device) if self.gates
                 else contextlib.nullcontext())
        torch.cuda.synchronize(self.device)
        try:
            with torch.cuda.graph(graph), gated:
                static_out = step(static_in)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the step for a feed of shape {n} failed: {e}"
            ) from e
        finally:
            if collecting:
                gc.enable()
            launches = counts.since(before)
            counts.restore(before)
        torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        if sp is not None:
            tracing.end(sp, t1)
        self._graphs[n] = _Captured(
            graph, static_in, static_out, launches, (t1 - t0) * 1e-9,
            graph_if.body_pool_bytes(self.device) - pool_bytes)
        return out

    def stats(self) -> dict:
        """Per captured feed shape (a length, or (B, L)): replays so far,
        whether conditional nodes gate the step, the kernel launches one
        replay makes outside them (the launches inside them count as run,
        on the device: ``counts.settle``), the capture's seconds (its
        ``capture`` span) and the bytes the body pools grew by in it."""
        return {n: {"replays": self.replays[n], "gated": self.gates,
                    "launches_per_replay": counts.total(c.launches),
                    "capture_s": c.capture_s,
                    "body_pool_bytes": c.body_pool_bytes}
                for n, c in self._graphs.items()}
