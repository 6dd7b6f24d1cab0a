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
ranks captures its step; gloo's cannot.  The group's timeout (120 s) makes a
rank that enters another collective than its peers fail instead of hanging.

``launch(fn, world, ...)`` runs ``fn(group, *args)`` on ``world`` ranks, one
spawned process each, which meet through a ``FileStore`` in a fresh
directory, and returns their results in rank order.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
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


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The ranks of one sharded map, as this rank sees them."""

    pg: Any  # torch.distributed process group
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" or "gloo"

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

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t``, in rank order, on ``t``'s
        device.  ``t`` is numeric (gloo takes no bool tensors).  Gathered
        into one flat output tensor made up front, which a CUDA graph can
        record on NCCL."""
        src = t.cpu() if self.host_copies else t
        out = src.new_empty((self.world * src.numel(),))
        _all_gather_single(out, src.reshape(-1).contiguous(), group=self.pg)
        return out.view(self.world, *t.shape).to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``t``, on ``t``'s device; ``t``
        itself is left alone."""
        out = t.cpu().clone() if self.host_copies else t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.pg)
        return out.to(t.device)

    def close(self) -> None:
        dist.destroy_process_group(self.pg)


def init_distributed(init_method: str, world: int, rank: int,
                     backend: str = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> ShardGroup:
    """Join the ranks of a sharded map; returns this rank's ``ShardGroup``.

    ``init_method`` is a ``torch.distributed`` rendezvous address
    (``"tcp://localhost:<port>"`` or ``"file://<path>"``).  ``device``
    defaults to CUDA, card ``rank % device_count`` (raises without CUDA;
    pass ``"cpu"`` for CPU ranks); ``backend`` to NCCL on a card and gloo on
    the CPU.  Ranks that share one card pass ``backend="gloo"``."""
    check_world(world)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ranks run on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for CPU ranks")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ShardGroup(dist.group.WORLD, rank, world, device, backend)


def _rank_main(fn, rank, world, init_method, backend, device, args, results):
    """A launched rank: join, run ``fn``, report (rank, ok, result)."""
    try:
        if torch.device("cuda" if device is None else device).type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        group = init_distributed(init_method, world, rank, backend, device)
        try:
            out = fn(group, *args)
        finally:
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
    return."""
    check_world(world)
    if (torch.device("cuda" if device is None else device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(
            "ranks run on CUDA by default and no CUDA device is available; "
            "pass device='cpu' for CPU ranks")
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
