"""Batched multi-stream LIO: B independent scan streams replayed in
lockstep rounds.

Port of ``fast_lio_tpu/batch.py`` with the same public surface
(``push_imu(i, ...)``, ``push_lidar(i, ...)``, ``mark_done``, ``spin_once``,
``get_trajectory(i)``, ``get_diags(i)``, ``imu_need_init``,
``truncated_points``).  This is LOCKSTEP FLEET REPLAY tooling (one process,
B bags, synchronized rounds, e.g. cross-vehicle comparison at matched
timestamps), not a throughput mode.

Semantics: streams advance in lockstep rounds — one packet per stream per
round, and a round fires only when every stream is ready or declared ended
via ``mark_done(i)``; the IMU static-init phase completes per stream on the
host, and the rounds start when every live stream is initialized.

How a round runs: the JAX package ``vmap``s the per-scan step over the
streams, one batched device program per round.  The port's step reads
nothing on the host, so a written-out batch dimension is possible now; it
is the next slice (ROADMAP.md A.21).  Until then the lanes of a round run
one after another on the card, each through its own single-stream
``Pipeline`` (on CUDA each captures its own graphs): every stream is the
single-stream code and matches a single ``Pipeline`` exactly.  A stream
that has ended runs nothing (the JAX package carries it as a zero-point
no-op lane of the batched step, which leaves its state untouched).  Unlike
the JAX package, where a round shares one pad (the largest bucket any of
its packets needs), each lane is padded for its own packet, as a single
``Pipeline`` pads it.
"""
from __future__ import annotations

import time
from typing import List, Optional

from .config import Config
from .pipeline import Pipeline, ScanPacket, StepDiag


class BatchPipeline:
    """B lockstep LIO streams, one ``Pipeline`` each, on one device."""

    def __init__(self, cfg: Config, n_streams: int, device=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1 (got {n_streams})")
        self.cfg = cfg
        self.B = n_streams
        self.pipes = [Pipeline(cfg, device=device) for _ in range(n_streams)]
        # a popped packet owns its IMU block (pop consumes the imu buffers),
        # so a packet that cannot run yet is stashed, never re-queued
        self._pending: List[Optional[ScanPacket]] = [None] * self.B
        self.done = [False] * self.B  # feeder-declared end of stream
        self._round_wall: List[List[float]] = [[] for _ in range(self.B)]

    # ---------------- per-stream state ----------------

    @property
    def imu_need_init(self) -> List[bool]:
        return [p.imu_need_init for p in self.pipes]

    @property
    def truncated_points(self) -> List[int]:
        return [p.truncated_points for p in self.pipes]

    @property
    def trajectory(self) -> List[list]:
        """Per stream, [(t, pos, quat), ...] with device tensors."""
        return [p.trajectory for p in self.pipes]

    # ---------------- feeding ----------------

    def push_imu(self, i: int, t, acc, gyr):
        self.pipes[i].push_imu(t, acc, gyr)

    def push_lidar(self, i: int, stamp, pts, pt_time, intensity=None):
        self.pipes[i].push_lidar(stamp, pts, pt_time, intensity)

    def mark_done(self, i: int):
        """Feeder declares stream i ended: the lockstep no longer waits for
        it."""
        self.done[i] = True

    def spin_once(self) -> bool:
        """Run one lockstep round.  Fires only when EVERY stream is either
        ready (has a packet past IMU init) or declared done via mark_done.
        Returns True if a round ran."""
        pkts: List[Optional[ScanPacket]] = list(self._pending)
        for i, pipe in enumerate(self.pipes):
            while pkts[i] is None:
                p = pipe.sync.pop_packet()
                if p is None:
                    break
                if pipe.imu_need_init:
                    pipe.process_packet(p)  # the init arm consumes it
                    continue
                pkts[i] = p
        self._pending = pkts
        if not any(p is not None for p in pkts):
            return False
        ready = all(p is not None or self.done[i]
                    for i, p in enumerate(pkts))
        init_pending = any(p.imu_need_init and not self.done[i]
                           for i, p in enumerate(self.pipes))
        if not ready or init_pending:
            return False  # hold the round (lockstep); packets stay stashed
        self._pending = [None] * self.B

        t0 = time.perf_counter()
        for pipe, p in zip(self.pipes, pkts):
            if p is not None:
                pipe.process_packet(p)
        wall = time.perf_counter() - t0
        for i, p in enumerate(pkts):
            if p is not None:
                self._round_wall[i].append(wall)
        return True

    # ---------------- results ----------------

    def get_trajectory(self, i: int):
        """Trajectory of stream i on the host: [(t, pos, quat), ...]."""
        return self.pipes[i].get_trajectory()

    def get_diags(self, i: int) -> List[StepDiag]:
        """Per-round diagnostics of stream i, counts read from the device;
        ``total_time`` is the round's wall time, as in the JAX package."""
        out = []
        for d, wall in zip(self.pipes[i].diags, self._round_wall[i]):
            out.append(StepDiag(
                n_raw=d.n_raw, n_truncated=d.n_truncated,
                n_down=int(d.n_down), n_effective=int(d.n_effective),
                iterations=int(d.iterations), map_size=int(d.map_size),
                total_time=wall, preprocess_time=d.preprocess_time))
        return out
