"""Batched multi-stream LIO: B independent scan streams replayed in
lockstep rounds, all B as one batched step a round.

Port of ``fast_lio_tpu/batch.py`` with the same public surface
(``push_imu(i, ...)``, ``push_lidar(i, ...)``, ``mark_done``, ``spin_once``,
``get_trajectory(i)``, ``get_diags(i)``, ``imu_need_init``,
``truncated_points``, ``trajectory``).  This is LOCKSTEP FLEET REPLAY
tooling (one process, B bags, synchronized rounds, e.g. cross-vehicle
comparison at matched timestamps).  On a TPU v5e the JAX package's batch
ran about 4x below time-slicing the same streams through single pipelines
(``fast_lio_tpu/batch.py``'s docstring).  Here it is the faster way on an
NVIDIA H100 80GB HBM3 at 700 W: four avia streams (``avia_batch4`` at the
AVIA preset) ran at 318.7 aggregate scans/s against 115.3 time-sliced
through four captured single pipelines, 2.76x (``chip_smoke.py`` phase
``fleet_batch4``; PERF.md).  A round of four lanes keeps the device busy
11.0 ms where one scan keeps it 8.4 ms: the step's count of device
activities, not their size, sets its time.

How a round runs: the counterpart of ``jax.vmap(packed)``.  The estimator
state of the B streams is stacked on a leading stream axis (``x``, ``P``,
the map, ``imu_carry``, ``lm_state``; ``Q`` is shared), and each round is
one call of ``torch.func.vmap`` over the single-stream step
(``pipeline.packed_step``, the same function ``Pipeline`` runs, so there is
no second copy of the math) on a (B, 8 + 7 M + 5 pad) feed buffer.  The
kNN search inside is the custom op ``fast_lio_tpu_torch::knn_search``,
whose vmap rule searches every lane's own map in one launch of the CUDA
kernel (``kernels/knn.py``).  The step runs with vmap's per-example
fallback disabled, so an op without a batching rule raises instead of
looping over the lanes.  On CUDA the batched step is captured in one CUDA
graph per pad bucket for the whole fleet (``step_graph.StepGraphs``) and
replayed once per round, with no host sync in steady state.  The graph is
gated as JAX's vmapped step is: the filter's passes are CUDA-graph IF nodes
that run while any lane is active (JAX's batched ``while_loop``:
``control_flow.loop_pass``), each lane keeping a pass's result only while
it is active itself, and every ``lax.cond`` whose predicate differs from
lane to lane (the re-search, the wide search, the prune, the update) stays
a select.  An ended stream's no-op lane never exits the loop, so a round
with one runs every pass, as in JAX.

Semantics, as in the JAX package: one packet per stream per round, and a
round fires only when every stream is ready or declared ended via
``mark_done(i)``; the IMU static-init phase completes per stream on the
host, and the rounds start when every live stream is initialized.  A round
shares one pad, the largest bucket any of its packets needs.  An ended
stream rides along as a zero-point no-op lane (n = 0, no IMU sample,
``do_update`` 0), whose state the step leaves as the JAX package's does;
nothing of it is recorded.  Each round's poses and counts are copied off
the graph on the device and read on the host only by ``get_trajectory``
and ``get_diags``; the one other host read is, per stream until its map
exists, whether its first scan seeded the map.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from . import imu as imu_mod
from . import state as st
from .config import Config
from .filter import process
from .map import hash_map as hm
from .pipeline import (Pipeline, ScanPacket, StepDiag, SyncBuffer,
                       _check_knn_backend, pack_buf, pad_for, packed_step)
from .step_graph import PinnedFeed, StepGraphs


@contextlib.contextmanager
def no_vmap_fallback():
    """vmap's per-example fallback off: an op with no batching rule raises
    instead of running once per lane."""
    enabled = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(enabled)


def _stack(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.stack([t] * n)


class BatchPipeline:
    """B lockstep LIO streams over one vmapped step.

    ``device`` defaults to ``"cuda"``; without CUDA the constructor raises
    unless the caller passes ``device="cpu"``.  On CUDA the batched step is
    captured per pad bucket; the CPU runs it eagerly.
    ``knn_backend="grouped"`` is refused (the grouped kernels have no
    stream axis, and the JAX package's batch has no grouped backend)."""

    def __init__(self, cfg: Config, n_streams: int, device=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1 (got {n_streams})")
        _check_knn_backend(cfg)
        if cfg.knn_backend == "grouped":
            raise ValueError(
                "BatchPipeline with knn_backend='grouped': the grouped "
                "kernels have no stream axis (ROADMAP.md), and the JAX "
                "package's batch has no grouped backend; use the default")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchPipeline runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain CPU path")
        self.cfg = cfg
        self.B = n_streams
        self.device = device
        self.dtype = dt = getattr(torch, cfg.compute_dtype)
        self.map_cfg = hm.make_config(
            voxel_size=cfg.filter_size_map,
            h_log2=cfg.map_h_log2,
            bucket_slots=cfg.map_bucket_slots,
            cell_multiplier=cfg.map_cell_multiplier,
        )
        if self.map_cfg.h_log2 > 15:
            raise ValueError(
                f"map_h_log2={cfg.map_h_log2}: the insert key layout "
                "requires map_h_log2 <= 15")
        self.sync = [SyncBuffer(cfg) for _ in range(self.B)]

        # batched estimator state: leading axis = stream, written in place
        # (a captured step reads and writes these tensors)
        B, H = self.B, self.map_cfg.num_buckets
        self.x = st.State(*(_stack(v, B)
                            for v in st.identity_state(dt, device)))
        self.P = _stack(torch.eye(st.DOF, dtype=dt, device=device), B)
        self.Q = process.process_noise_cov(
            cfg.gyr_cov, cfg.acc_cov, cfg.b_gyr_cov, cfg.b_acc_cov, dt,
            device)  # shared, unbatched
        m = hm.make_map(self.map_cfg, dt, device)
        rows = _stack(m.rows, B)  # (B, H + 1, 4B): each lane's dump row
        self.map = hm.Map(packed=rows[:, :H], dropped=_stack(m.dropped, B),
                          rows=rows)
        self.imu_carry = imu_mod.ImuCarry(
            *(_stack(v, B) for v in imu_mod.init_imu_carry(dt, device)))
        self.lm_state = (torch.zeros((B, 3), dtype=dt, device=device),
                         torch.zeros((B, 3), dtype=dt, device=device),
                         torch.zeros(B, dtype=torch.bool, device=device))

        # per-stream host state (mirrors Pipeline)
        self.imu_stats = [imu_mod.empty_stats() for _ in range(B)]
        self.imu_need_init = [True] * B
        self.acc_scale = [1.0] * B
        self.first_lidar_time: List[Optional[float]] = [None] * B
        self.last_lidar_end_time = [0.0] * B
        self.map_built = [False] * B
        self.truncated_points = [0] * B
        self._warned_truncation = False
        self.pad_buckets = tuple(sorted(set(
            cfg.pad_buckets or (cfg.n_points_max,))))
        # a popped packet owns its IMU block (pop consumes the imu buffers),
        # so a packet that cannot run yet is stashed, never re-queued
        self._pending: List[Optional[ScanPacket]] = [None] * B
        self.done = [False] * B  # feeder-declared end of stream
        # per stream: (stamp, round's poses (B, 7), lane); the poses are
        # device copies made once per round
        self._poses: List[list] = [[] for _ in range(B)]
        # per stream: (StepDiag without counts, round index); the counts are
        # each round's (B, 4) device copy, read in get_diags
        self._diag_rows: List[list] = [[] for _ in range(B)]
        self._round_diags: List[torch.Tensor] = []
        self._diags_read = np.zeros((0, B, 4), np.int64)
        cuda = device.type == "cuda"
        self.feed = PinnedFeed() if cuda else None
        self.graphs = StepGraphs(device) if cuda else None
        self.rounds = 0
        # the last round's (B, N, 3) downsampled world points, as
        # Pipeline.last_pts_world (a lane without a scan: its no-op's)
        self.last_pts_world = None

    # ---------------- state ----------------

    # the stacked state, copied in place: a map's ``packed`` is (B, H, 4B)
    # and its ``dropped`` (B,)
    load_state = Pipeline.load_state

    # ---------------- the step on the device ----------------

    def _lane(self, x, P, rows, dropped, imu_carry, buf, lm_lo, lm_hi,
              lm_init):
        """One lane of the batched step: ``packed_step`` on one stream's
        state (its map's rows are updated in place)."""
        m = hm.Map(rows[:self.map_cfg.num_buckets], dropped, rows)
        x, P, m, imu_carry, lm_state, out = packed_step(
            self.cfg, self.map_cfg, x, P, m, imu_carry, self.Q, buf,
            lm_lo, lm_hi, lm_init)
        return x, P, m.dropped, imu_carry, lm_state, dict(
            pose=out["pose"], diag=out["diag"], world=out["world"])

    def _batched_step(self, buf: torch.Tensor) -> dict:
        """Every lane's scan from the (B, L) feed buffer in one vmapped
        step; the new state is written into the batch's tensors.  Returns
        ``pose`` (B, 7), ``diag`` (B, 4) int64 and ``world`` (B, N, 3),
        each lane's downsampled points in the world frame (``Pipeline``'s
        ``last_pts_world``).  Reads nothing on the
        host, so ``StepGraphs`` captures it."""
        with no_vmap_fallback():
            x, P, dropped, imu_carry, lm_state, out = torch.func.vmap(
                self._lane)(self.x, self.P, self.map.rows, self.map.dropped,
                            self.imu_carry, buf, *self.lm_state)
        self.load_state(x=x, P=P, imu_carry=imu_carry, lm_state=lm_state)
        self.map.dropped.copy_(dropped)
        return out

    def _run_round(self, bufs: np.ndarray) -> dict:
        """Run the batched step on the round's (B, L) buffer: on CUDA a
        graph replay (a new pad's first round runs eagerly, then the
        capture), whose outputs are copied off the graph on the device; on
        the CPU the eager step.  Returns pose, diag and world."""
        if self.feed is None:  # the CPU: no copy
            return self._batched_step(torch.from_numpy(bufs))
        host = self.feed.take(bufs.shape)
        host.numpy()[...] = bufs
        out = self.graphs.run(host, self._batched_step)
        self.feed.copied()
        return {k: v.clone() for k, v in out.items()}

    # ---------------- feeding ----------------

    def push_imu(self, i: int, t, acc, gyr):
        self.sync[i].push_imu(float(t), acc, gyr)

    def push_lidar(self, i: int, stamp, pts, pt_time, intensity=None):
        self.sync[i].push_lidar(float(stamp), pts, pt_time, intensity)

    def _host_init(self, i: int, pkt: ScanPacket) -> bool:
        """Per-stream IMU static init (``Pipeline.process_packet``'s init
        arm).  Returns True if the packet was consumed by the init phase."""
        cfg = self.cfg
        if self.first_lidar_time[i] is None:
            self.first_lidar_time[i] = pkt.lidar_beg_time
        if not self.imu_need_init[i]:
            return False
        if len(pkt.imu_t):
            self.imu_stats[i] = imu_mod.update_stats(
                self.imu_stats[i], pkt.imu_acc, pkt.imu_gyr)
            if self.imu_stats[i].n > cfg.max_ini_count:
                x0, P0 = imu_mod.make_init_state(
                    self.imu_stats[i], cfg.extrinsic_R_mat,
                    cfg.extrinsic_T_vec, self.dtype, self.device)
                for dst, src in zip(self.x, x0):
                    dst[i].copy_(src)
                self.P[i].copy_(P0)
                self.acc_scale[i] = float(
                    st.G_M_S2 / np.linalg.norm(self.imu_stats[i].mean_acc))
                self.imu_need_init[i] = False
        self.last_lidar_end_time[i] = pkt.lidar_end_time
        return True

    def mark_done(self, i: int):
        """Feeder declares stream i ended: the lockstep no longer waits for
        it (its lane runs no-op packets)."""
        self.done[i] = True

    def _lane_buf(self, i: int, p: Optional[ScanPacket], pad: int):
        """Stream i's feed buffer for this round: its packet, or for an
        ended stream the JAX package's no-op packet (no point, no IMU
        sample, no update)."""
        cfg = self.cfg
        if p is None:
            t = self.last_lidar_end_time[i]
            empty = ScanPacket(
                lidar_beg_time=t, lidar_end_time=t,
                pts=np.zeros((0, 3), np.float32), pt_time=np.zeros(0),
                imu_t=np.zeros(0), imu_acc=np.zeros((0, 3)),
                imu_gyr=np.zeros((0, 3)))
            return pack_buf(cfg, self.acc_scale[i], empty, 0.0, 0.0, False,
                            False, n_max=pad)
        trunc = max(0, len(p.pts) - pad)
        if trunc:  # mirror Pipeline.process_packet's accounting
            self.truncated_points[i] += trunc
            if not self._warned_truncation:
                self._warned_truncation = True
                warnings.warn(
                    f"stream {i}: scan of {len(p.pts)} points exceeds "
                    f"the largest pad bucket {pad}; {trunc} points "
                    "dropped (counted in BatchPipeline.truncated_points)")
        last_end_rel = self.last_lidar_end_time[i] - p.lidar_beg_time
        pcl_end_rel = p.lidar_end_time - p.lidar_beg_time
        ekf_inited = (
            p.lidar_beg_time - self.first_lidar_time[i]) >= cfg.init_time
        buf = pack_buf(cfg, self.acc_scale[i], p, last_end_rel, pcl_end_rel,
                       ekf_inited, self.map_built[i], n_max=pad)
        self.last_lidar_end_time[i] = p.lidar_end_time
        return buf

    def spin_once(self) -> bool:
        """Run one lockstep round.  Fires only when EVERY stream is either
        ready (has a packet past IMU init) or declared done via mark_done —
        so misaligned feeds batch properly instead of burning B-wide rounds
        with one live lane.  Returns True if a device round ran."""
        # drain init-phase packets per stream; stash the first runnable one
        pkts: List[Optional[ScanPacket]] = list(self._pending)
        for i in range(self.B):
            while pkts[i] is None:
                p = self.sync[i].pop_packet()
                if p is None:
                    break
                if self._host_init(i, p):
                    continue
                pkts[i] = p
        self._pending = pkts
        if not any(p is not None for p in pkts):
            return False
        ready = all(p is not None or self.done[i]
                    for i, p in enumerate(pkts))
        init_pending = any(self.imu_need_init[i] and not self.done[i]
                           for i in range(self.B))
        if not ready or init_pending:
            return False  # hold the round (lockstep); packets stay stashed
        self._pending = [None] * self.B

        t0 = time.perf_counter()
        pad = max(pad_for(self.pad_buckets, len(p.pts))
                  for p in pkts if p is not None)
        n_trunc = [max(0, len(p.pts) - pad) if p is not None else 0
                   for p in pkts]
        out = self._run_round(np.stack(
            [self._lane_buf(i, p, pad) for i, p in enumerate(pkts)]))
        pose, diag = out["pose"], out["diag"]
        self.last_pts_world = out["world"]
        wall = time.perf_counter() - t0
        r = len(self._round_diags)
        self._round_diags.append(diag)
        for i, p in enumerate(pkts):
            if p is None:
                continue
            if not self.map_built[i]:
                # one read per stream, until its map exists (as JAX)
                self.map_built[i] = int(diag[i, 0]) > 5
            self._poses[i].append((p.lidar_end_time, pose, i))
            self._diag_rows[i].append((StepDiag(
                n_raw=len(p.pts), n_truncated=n_trunc[i], total_time=wall,
                preprocess_time=p.preprocess_time), r))
        self.rounds += 1
        return True

    # ---------------- results ----------------

    @property
    def trajectory(self) -> List[list]:
        """Per stream, [(t, pos (3,), quat (4,)), ...], device tensors."""
        return [[(t, pose[j, :3], pose[j, 3:]) for t, pose, j in s]
                for s in self._poses]

    def get_trajectory(self, i: int):
        """Trajectory of stream i on the host: [(t, pos, quat), ...]."""
        rows = self._poses[i]
        if not rows:
            return []
        poses = torch.stack([pose[j] for _, pose, j in rows]).cpu().numpy()
        poses = poses.astype(np.float64)
        return [(t, p[:3], p[3:]) for (t, _, _), p in zip(rows, poses)]

    def get_diags(self, i: int) -> List[StepDiag]:
        """Per-round diagnostics of stream i.  The rounds' counts are read
        from the device once (every round not read before, in one copy);
        ``total_time`` is the round's wall time, as in the JAX package."""
        done = len(self._diags_read)
        if done < len(self._round_diags):
            new = torch.stack(self._round_diags[done:]).cpu().numpy()
            self._diags_read = np.concatenate([self._diags_read, new])
        out = []
        for diag, r in self._diag_rows[i]:
            n_down, n_eff, iters, map_size = (int(v) for v in
                                              self._diags_read[r, i])
            out.append(StepDiag(
                n_raw=diag.n_raw, n_truncated=diag.n_truncated,
                n_down=n_down, n_effective=n_eff, iterations=iters,
                map_size=map_size, total_time=diag.total_time,
                preprocess_time=diag.preprocess_time))
        return out
