"""The cells' driver: how a traffic mix feeds the port and what a run keeps
for the metrics and the output check.

``replay``  the host hands each packet to ``Pipeline.process_packet`` as
            soon as it can (the pinned feed lets it run ahead of the
            device); the window ends after a drain.
``online``  closed loop: each packet's pose is read on the host before the
            next packet is handed over.

Each scan's driver message goes through the port's decoder
(``preprocess.drivers.decode``) and, with the IMU samples up to its end,
into the pipeline's sync buffer, as the port's command line feeds a bag.
The driver warms up over the ramp and ``warm_laps`` laps (IMU init, the map
filled, the step's graph captured), keeps the program's state after each of
the first ``start_packets`` packets (the output check's start), and in the
window keeps the state around ``chains`` runs of ``steps`` consecutive
scans (its chains), each starting at the first scan after a time drawn from
the seed in the window.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import traffic
from .reference.lio import STATE_KEYS

def drain(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, on: bool):
    """A named host range in the profiler's trace (when tracing)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def chain_times(seed: int, n_chains: int, seconds: float) -> List[float]:
    """``n_chains`` times in [0, seconds) drawn from the seed, sorted."""
    rng = np.random.default_rng(traffic.seed_words(seed, 1 << 20))
    return sorted(float(t) for t in rng.uniform(0.0, seconds, n_chains))


def host_cpu() -> Tuple[Optional[int], Optional[float]]:
    """The CPU the calling thread last ran on and its clock in MHz, as
    ``/proc`` reads them (None where it cannot)."""
    try:
        with open("/proc/thread-self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
        with open("/proc/cpuinfo") as f:
            blocks = f.read().split("\n\n")
        for b in blocks:
            fields = dict(line.split(":", 1) for line in b.splitlines()
                          if ":" in line)
            fields = {k.strip(): v.strip() for k, v in fields.items()}
            if fields.get("processor") == str(cpu):
                return cpu, float(fields.get("cpu MHz", "nan"))
        return cpu, None
    except (OSError, ValueError, IndexError):
        return None, None


def _state(x, P):
    return {k: v.clone() for k, v in zip(STATE_KEYS, x)}, P.clone()


def snap_pre(pipe) -> Dict:
    """The estimator state before a chain; device copies made in order on
    the current stream, so a replay enqueued before is in them."""
    x, P = _state(pipe.x, pipe.P)
    carry = pipe.imu_carry
    lo, hi, init = pipe.lm_state
    return dict(x=x, P=P, packed=pipe.map.packed.clone(),
                angvel_last=carry.angvel_last.clone(),
                acc_s_last=carry.acc_s_last.clone(),
                lm_lo=lo.clone(), lm_hi=hi.clone(), lm_init=init.clone(),
                acc_scale=pipe.acc_scale,
                first_lidar_time=pipe.first_lidar_time,
                last_end=pipe.last_lidar_end_time, map_built=pipe.map_built)


def snap_post(pipe) -> Dict:
    """The state after a step, the pose it reported and the filter's
    passes."""
    x, P = _state(pipe.x, pipe.P)
    _t, pos, quat = pipe.trajectory[-1]
    return dict(x=x, P=P, pose=(pos.clone(), quat.clone()),
                passes=pipe.diags[-1].iterations)


class Single:
    """One stream through a ``Pipeline``."""

    def __init__(self, cell, program, seed: int, device, tracing: bool):
        self.cell = cell
        self.mix = cell.mix
        self.seed = seed
        self.device = torch.device(device)
        self.tracing = tracing
        self.cfg = cell.program_config()
        self.decode = program.decode
        self.lap = traffic.make_lap(cell.sensor, cell.config["extrinsic_T"],
                                    self.mix, self.device)
        self.stream = traffic.Stream(self.lap, cell.noise, seed)
        self.last = None  # the last scan's (message, imu t, acc, gyr)
        chk = self.mix["check"]
        self.steps = int(chk["steps"])
        self.start_packets = int(chk["start_packets"])
        self.start = dict(records=[], posts=[])
        self.chains: List[Dict] = []
        self.attempted = 0
        self.failed = 0
        self.pipe = program.Pipeline(self.cfg, device=self.device)
        self.online = self.mix["driver"] == "online"
        self.waited = 0.0
        if tracing and self.pipe.feed is not None:
            self._time_feed_waits()

    def _time_feed_waits(self):
        """Time the pinned feed's ``take`` (where the host waits when it
        runs a ring ahead of the device), so the enqueue span can leave the
        wait out."""
        take = self.pipe.feed.take

        def timed(shape):
            t0 = time.perf_counter()
            try:
                return take(shape)
            finally:
                self.waited += time.perf_counter() - t0
        self.pipe.feed.take = timed

    def _packet(self):
        """The next scan's message decoded and handed to the sync buffer
        with the IMU samples up to its end; its packet."""
        pipe = self.pipe
        msg, _k = self.stream.scan()
        t, acc, gyr = self.stream.imu_until(msg["stamp"] + self.lap.period)
        for i in range(len(t)):
            pipe.push_imu(float(t[i]), acc[i], gyr[i])
        scan = self.decode(msg, self.cfg)
        pipe.push_lidar(msg["stamp"], scan.pts, scan.time_offset_s,
                        scan.intensity)
        self.last = (msg, t, acc, gyr)
        pkt = pipe.sync.pop_packet()
        if pkt is None or pipe.sync.pop_packet() is not None:
            raise RuntimeError("the stream did not make one packet a scan")
        return self.last, pkt

    def warm_scans(self) -> int:
        return self.lap.ramp_scans + int(self.mix["warm_laps"]) * \
            self.lap.lap_scans

    def warm(self):
        pipe = self.pipe
        for s in range(self.warm_scans()):
            rec, pkt = self._packet()
            n_traj = len(pipe.trajectory)
            pipe.process_packet(pkt)
            if s < self.start_packets:
                self.start["records"].append(rec)
                grew = len(pipe.trajectory) > n_traj
                self.start["posts"].append(snap_post(pipe) if grew else None)
        drain(self.device)

    def plan_chains(self, seconds: float):
        self.chain_at = chain_times(
            self.seed, int(self.mix["check"]["chains"]), seconds)

    def _scan(self, out: Dict, since: Optional[float] = None,
              spans: Optional[List] = None):
        """A scan of a window: feed, hand over, (online) read the pose
        back; a chain starts where the window's clock (``since`` its start)
        has passed the next chain's time and none is running."""
        pipe = self.pipe
        chain = self._chain
        if (chain is None and since is not None and self._next < len(
                self.chain_at) and time.perf_counter() - since
                >= self.chain_at[self._next]):
            self._next += 1
            chain = self._chain = dict(prev=self.last, pre=snap_pre(pipe),
                                       records=[], posts=[])
            self.chains.append(chain)
        with span("liobench.feed", self.tracing):
            rec, pkt = self._packet()
        waited = self.waited
        if spans is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with span("liobench.process_packet", self.tracing):
            pipe.process_packet(pkt)
        t1 = time.perf_counter()
        if spans is not None:
            ev[1].record()
            spans.append(ev)
        out["enqueue_s"].append(t1 - t0)
        out["feed_wait_s"].append(self.waited - waited)
        if self.online:
            with span("liobench.readback", self.tracing):
                _t, pos, quat = pipe.trajectory[-1]
                torch.cat([pos, quat]).cpu()
            out["latency_s"].append(time.perf_counter() - t0)
        if chain is not None:
            chain["records"].append(rec)
            chain["posts"].append(snap_post(pipe))
            if len(chain["posts"]) == self.steps:
                self._chain = None

    def window(self, seconds: float) -> Dict:
        """Scans for ``seconds``, then a drain: the wall time, the scans,
        each scan's enqueue (and, online, latency) host times, once a second
        the scans so far and the host's CPU and clock, and in a traced run
        on CUDA each scan's device span (``spans``, s): CUDA events on the
        stream before and after its ``process_packet``.  While the host runs
        ahead, the device reaches the first only when the scan before is
        done and the scan's work is already queued, so a span is the scan's
        device time (copies, kernels and the gaps between them); where the
        host falls behind, the device's wait for it falls in the span."""
        out = dict(enqueue_s=[], latency_s=[], feed_wait_s=[], seconds=[])
        events = [] if self.tracing and self.device.type == "cuda" else None
        self._chain = None
        self._next = 0
        n_diag = len(self.pipe.diags)
        t0 = time.perf_counter()
        mark = t0
        k = 0
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if now >= mark:
                out["seconds"].append([round(now - t0, 3), k, *host_cpu()])
                mark += 1.0
            self._scan(out, since=t0, spans=events)
            k += 1
        drain(self.device)
        out["wall_s"] = time.perf_counter() - t0
        out["scans"] = k
        if events is not None:
            out["spans"] = [a.elapsed_time(b) * 1e-3 for a, b in events]
        out["diags"] = self.pipe.diags[n_diag:]
        self._chain = None
        self.attempted += k
        return out

    def scans(self, n: int) -> Dict:
        """Exactly ``n`` scans, then a drain (the profiled window)."""
        out = dict(enqueue_s=[], latency_s=[], feed_wait_s=[], world=[],
                   raw=[])
        self._chain = None
        t0 = time.perf_counter()
        for _ in range(n):
            self._scan(out)
            out["world"].append((self.pipe.last_pts_world,
                                 self.pipe.last_pts_world_mask))
            out["raw"].append(self.last[0])
        drain(self.device)
        out["wall_s"] = time.perf_counter() - t0
        out["scans"] = n
        return out

    def live_queries(self, out: Dict) -> None:
        """The profiled scans' searched points, for the rooflines: each
        scan's downsampled points in the world frame."""
        out["queries"] = [w[m] for w, m in out.pop("world")]

    def nonfinite_poses(self, n_last: int) -> int:
        """How many of the last ``n_last`` poses are not finite."""
        if not n_last:
            return 0
        poses = torch.stack([torch.cat([p, q]) for _t, p, q in
                             self.pipe.trajectory[-n_last:]])
        return int((~torch.isfinite(poses).all(-1)).sum())

    def map_packed(self):
        return self.pipe.map.packed

    def release(self):
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


DRIVERS = {"replay": Single, "online": Single}
