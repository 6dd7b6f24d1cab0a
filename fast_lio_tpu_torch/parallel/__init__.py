"""Ranks of a sharded map: the process group, its collectives, and a launcher.

Port of ``fast_lio_tpu/parallel/__init__.py`` (``init_distributed``).  The
JAX package runs every shard of the map in one program over a device mesh;
here a shard is a process (a rank), and ``init_distributed`` returns a
``ShardGroup``, which plays the mesh's role: the process group, this rank,
the world size, the rank's device and the backend.

Backends: NCCL for ranks on CUDA devices, one card each (the default there);
gloo for CPU ranks (the default there, and what the tests use); gloo also for
ranks that share one card, since NCCL refuses two ranks on one device.  gloo
is given host tensors: for ranks on a card it copies each tensor to the host
and back (``ShardGroup.transport`` names it).  That is the transport the
caller chose, not a fallback.  NCCL's collectives can be recorded in a
CUDA graph (``ShardGroup.capturable``), so a sharded ``Pipeline`` on NCCL
ranks captures its step, with its gates as CUDA-graph conditional (IF)
nodes whose bodies hold collectives; gloo's cannot.  An IF node's body
takes kernel nodes but no event record or wait nodes, and NCCL adds such
nodes to a capture unless its graph mixing support is off: NCCL ranks run
with ``NCCL_GRAPH_MIXING_SUPPORT=0`` (``init_distributed``).  With it on
(NCCL 2.28.9, CUDA 12.8, four H100s), ending the capture of a step whose IF
node holds an all-reduce across four ranks raised "CUDA error: invalid
argument".  With it off, NCCL does not support a replay of a graph that
holds the communicator's collectives being outstanding together with a
collective launched outside a capture, whatever the stream order: the
group drains the card where one kind of launch follows the other
(``ShardGroup.launching``).  The group's timeout (120 s) makes a
rank that enters another collective than its peers fail instead of hanging.

``launch(fn, world, ...)`` runs ``fn(group, *args)`` on ``world`` ranks, one
spawned process each, which meet through a ``FileStore`` in a fresh
directory, and returns their results in rank order.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0  # a collective that waits longer raises
BACKENDS = ("nccl", "gloo")
# the all-gather into one flat tensor: PyTorch 2.11 has it only as
# ``all_gather_into_tensor``; 2.13 names it ``all_gather_single`` and warns
# that the old name is deprecated
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def check_world(world: int) -> None:
    """Raise ValueError unless ``world`` is a power of two: shard ownership
    takes the hash bits above the bucket index (``sharding.local_map_cfg``)."""
    if world < 1 or world & (world - 1):
        raise ValueError(f"the world size must be a power of two (got {world})")


class InFlight:
    """The kind of NCCL work this rank last launched on a group's
    communicator and has not drained since: "graph" (a replay of a CUDA
    graph that holds the group's collectives), "eager" (a collective
    launched outside a capture) or None; ``drains`` counts the drains."""

    def __init__(self):
        self.kind = None
        self.drains = 0


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks of one sharded map, as this rank sees them."""

    pg: Any  # torch.distributed process group
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" or "gloo"
    in_flight: InFlight = dataclasses.field(
        default_factory=InFlight, compare=False, repr=False)

    @property
    def host_copies(self) -> bool:
        """gloo on a card: collectives go through host copies."""
        return self.backend == "gloo" and self.device.type != "cpu"

    @property
    def transport(self) -> str:
        return "gloo through host copies" if self.host_copies else self.backend

    @property
    def capturable(self) -> bool:
        """NCCL on CUDA: the collectives can be recorded in a CUDA graph.
        gloo's cannot (on a card they copy through the host)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def launching(self, kind: str) -> None:
        """Call before this rank launches NCCL work of ``kind`` on the
        group: "graph", a replay of a CUDA graph that holds the group's
        collectives, or "eager", a collective outside a capture (the
        collectives below call it).  NCCL ranks run with graph mixing
        support off (``init_distributed``), under which the two kinds must
        never be outstanding together on one communicator, whatever the
        stream order: where one kind follows the other, the card is drained
        first (a host wait).  Replays alone, or eager steps alone, never
        wait.  Nothing to do on gloo, nor while a graph is being captured
        (a capture launches nothing)."""
        if not self.capturable or torch.cuda.is_current_stream_capturing():
            return
        if self.in_flight.kind not in (None, kind):
            torch.cuda.synchronize(self.device)
            self.in_flight.drains += 1
        self.in_flight.kind = kind

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t``, in rank order, on ``t``'s
        device.  ``t`` is numeric (gloo takes no bool tensors).  Gathered
        into one flat output tensor made up front, which a CUDA graph can
        record on NCCL."""
        self.launching("eager")
        src = t.cpu() if self.host_copies else t
        out = src.new_empty((self.world * src.numel(),))
        _all_gather_single(out, src.reshape(-1).contiguous(), group=self.pg)
        return out.view(self.world, *t.shape).to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``t``, on ``t``'s device; ``t``
        itself is left alone."""
        self.launching("eager")
        out = t.cpu().clone() if self.host_copies else t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.pg)
        return out.to(t.device)

    def close(self) -> None:
        dist.destroy_process_group(self.pg)


def _resolve(device, backend):
    """(device, backend) as a rank takes them: CUDA by default (raises
    without it), NCCL on a card and gloo on the CPU by default."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ranks run on CUDA by default and no CUDA device is available; "
            "pass device='cpu' for CPU ranks")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks")
    return device, backend


def check_cards(world: int, backend: str, shared: bool = False) -> None:
    """Raise ValueError unless ``world`` NCCL ranks get a card each
    (``shared``: the caller gave them all one card): NCCL refuses two ranks
    on one device, and nothing shrinks the world to the cards present.
    Ranks that share a card pass ``backend="gloo"``."""
    cards = torch.cuda.device_count() if backend == "nccl" else 0
    if backend == "nccl" and (world > cards or (shared and world > 1)):
        raise ValueError(
            f"{world} NCCL ranks on {1 if shared else cards} card(s): NCCL "
            "takes one card a rank (ranks sharing a card pass "
            "backend='gloo')")


def init_distributed(init_method: str, world: int, rank: int,
                     backend: str = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> ShardGroup:
    """Join the ranks of a sharded map; returns this rank's ``ShardGroup``.

    ``init_method`` is a ``torch.distributed`` rendezvous address
    (``"tcp://localhost:<port>"`` or ``"file://<path>"``).  ``device``
    defaults to CUDA, card ``rank % device_count`` (raises without CUDA;
    pass ``"cpu"`` for CPU ranks); ``backend`` to NCCL on a card and gloo
    on the CPU.  NCCL ranks take a card each (``check_cards``); ranks that
    share one card pass ``backend="gloo"``."""
    check_world(world)
    device, backend = _resolve(device, backend)
    check_cards(world, backend)
    if backend == "nccl":
        # no event nodes in a capture: an IF node's body refuses them (the
        # module's docstring); read by NCCL when the communicator is made.
        # A graph's collectives and eager ones must then never be
        # outstanding together, even in stream order: ShardGroup.launching
        # drains the card between the two kinds.
        os.environ["NCCL_GRAPH_MIXING_SUPPORT"] = "0"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ShardGroup(dist.group.WORLD, rank, world, device, backend)


def _rank_main(fn, rank, world, init_method, backend, device, args, results):
    """A launched rank: join, run ``fn``, report (rank, ok, result).  A
    failure is reported at once, with no teardown: the peers may wait in a
    collective, and ``launch`` ends them all.  After a success, what ``fn``
    left (pipelines, their CUDA graphs with NCCL kernels recorded in them)
    is freed and the card drained before the communicator is destroyed."""
    try:
        if torch.device("cuda" if device is None else device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        group = init_distributed(init_method, world, rank, backend, device)
        out = fn(group, *args)
        gc.collect()
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        group.close()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch(fn: Callable, world: int, args: Sequence = (), backend: str = None,
           device=None, store_dir=None, timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` ranks, each a spawned process;
    returns the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  The ranks
    meet through a ``FileStore`` in a fresh directory under ``store_dir``
    (default: the system's temporary directory).  ``device`` and ``backend``
    are each rank's, as ``init_distributed`` takes them.  A rank that raises
    or dies stops the others, and ``launch`` raises with its traceback; so
    does a launch that outlasts ``timeout_s``.  Every process is ended on
    return.  Ranks on CUDA find the kernels built: they are built here,
    once, before the ranks start (``kernels.build.build_all``)."""
    check_world(world)
    resolved, backend_used = _resolve(device, backend)
    check_cards(world, backend_used, shared=resolved.index is not None)
    if resolved.type == "cuda":
        from ..kernels import build

        build.build_all(build.LIBS)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="shards_", dir=store_dir) as tmp:
        init_method = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world, init_method, backend, device, tuple(args),
            results)) for rank in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout_s)
        except BaseException:
            for p in procs:  # the others may wait in a collective
                p.kill()
            raise
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, timeout_s: float) -> List[Any]:
    """The ranks' results in rank order; raises on the first failure."""
    world = len(procs)
    out = {}
    deadline = time.monotonic() + timeout_s
    dead_at = {}  # rank -> when it was seen to exit without reporting
    while len(out) < world:
        try:
            rank, ok, val = results.get(timeout=1.0)
        except queue.Empty:
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))}"
                                   f" did not finish within {timeout_s} s")
            for r, p in enumerate(procs):
                if r not in out and p.exitcode not in (None, 0):
                    # its report, if any, is still in the pipe: give it time
                    if now - dead_at.setdefault(r, now) > 5.0:
                        raise RuntimeError(
                            f"rank {r} died (exit code {p.exitcode})")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{val}")
        out[rank] = val
    return [out[r] for r in range(world)]
