"""The sharded step across cards: n NCCL ranks, one card each.

The counterpart of the JAX package's sharded step over an n-device mesh
(``make_sharded_step``) and of its ``dryrun_multichip``.  Run from the
repository root on a machine with one or more cards:

    python3 -m fast_lio_tpu_torch.tools.multicard [--ranks N]
    python3 -m fast_lio_tpu_torch.tools.multicard --device cpu [--ranks N]

N defaults to the largest power of two not above the cards present, at
most 4; asking for more ranks than cards raises.  One launch of N ranks
(``parallel.launch``) runs the phases below on every rank, and a second
launch of N fresh ranks resumes the checkpoint the first one wrote.  One
JSON row per phase, then a summary line that ends with the card's name and
power limit:

* ``dryrun``: ``sharding.dryrun_rank`` on the N ranks, two chained sharded
  steps against the unsharded step, with the JAX package's bounds.
* ``sharded_ouster64_ranks_if_node_probe`` and ``..._while_node_probe``
  (on cards): an all-reduce and an all-gather recorded inside one IF node
  (``if_node_rank``) and inside one WHILE node's body, replayed for 1, 3
  and 5 passes (``while_node_rank``), right on every rank.
* ``sharded_ouster64_ranks``: ``PRESETS["ouster64"]`` with
  ``n_points_max=45056`` (``chip_smoke.py`` phases 5 and 10) on 20 sim
  scans of 44k points, through ``bench_scaling.drive_modes``: eager, then
  captured (one CUDA graph per pad bucket on every rank, the collectives
  inside), each with 6 scans one by one, a window without a host sync
  under ``set_sync_debug_mode("error")`` and 4 scans under the profiler;
  then the health check, the stage times against the gathered global map
  and the pose covariance.  Checks: every rank's trajectory bit-identical,
  captured within 5 mm of eager, ATE within the JAX package's + 1 cm, the
  global map drops within 10% of its 307, the R = 8 and R = 27 kernels
  launched on every rank (counted through the replays), one graph per pad
  bucket with replays = steps - graphs, no host sync, positive stage
  times; the captured step is gated (its re-searches, wide search and
  prune CUDA-graph IF nodes, its passes one WHILE node, with their
  collectives inside), so its
  kNN launches and NCCL all-gather and all-reduce kernels (profiler) a
  step are at most the eager step's, which runs every pass and arm, the
  same on every rank, and on two or more cards some of each; the kNN
  launches counted as run equal the profiler's.  The row gives the passes
  a step run in the profiled scans, captured and eager, and a hash of rank
  0's positions (``positions_digest``), by which two runs are held bit for
  bit to each other.
  Positions are not held against the unsharded run in float32: a reordered
  sum may flip a gate (tests/test_torch_sharding.py).
* ``sharded_ouster64_ranks_f64``: the same scans in float64, captured,
  against the unsharded float64 captured run on rank 0's card: within
  1e-6 m per scan, with the same passes (iterations) scan by scan (no gate
  flips in float64).
* ``checkpoint_ranks``: the captured run checkpointed after scan 10 (every
  rank writes the global map to its own file); N fresh ranks resume it and
  run the rest captured, within 5 mm of the uninterrupted run; a pipeline
  sharded 2N ways refuses the checkpoint (ValueError).

``--device cpu`` rehearses the same phases on gloo CPU ranks at a tiny size
(the plain kNN, eager, no profile, no JAX reference to hold the ATE and
drops to).  It is never a fallback: without it, and with no card, the tool
exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import config, sim
from ..parallel import launch
from ..parallel import sharding
from ..pipeline import Pipeline
from ..utils import checkpoint as ckpt
from . import bench_scaling

# the JAX package's ATE (raw, aligned) and map drops on this ouster64 run,
# from tests/torch_reference_ate.py (chip_smoke.py holds the same values)
JAX_OUSTER64 = {"ate_m": (0.03198349476697826, 0.01154589455923144),
                "dropped": 307}
ATE_SLACK_M = 0.01
DROPPED_SLACK = 0.1  # which points overflow a full bucket rounds with f32
POS_TOL_M = 5e-3  # float32: captured against eager, resumed against whole
F64_TOL_M = 1e-6  # tests/test_torch_sync_free.py's one-rank float64 bound
MAX_RANKS = 4


@dataclasses.dataclass(frozen=True)
class Scale:
    """A run's configuration, sim data and scan counts."""

    cfg: config.Config
    sim_cfg: sim.SimConfig
    scans: int
    warm: int  # scans one by one before the window without a sync
    profile: int  # the last scans, under the profiler (cards only)
    ckpt_at: int  # the checkpoint is written after this many scans
    jax_ref: Optional[dict]  # JAX_OUSTER64 at full size, else None


def full_scale() -> Scale:
    """ouster64 as ``chip_smoke.py`` phases 5 and 10 run it."""
    cfg = dataclasses.replace(config.PRESETS["ouster64"], n_points_max=45056)
    return Scale(cfg, sim.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                                    elev_min=-22.5, elev_max=22.5),
                 scans=20, warm=6, profile=4, ckpt_at=10, jax_ref=JAX_OUSTER64)


def tiny_scale() -> Scale:
    """The CPU rehearsal: ouster64's wide fallback at small pads and map."""
    cfg = dataclasses.replace(
        config.PRESETS["ouster64"], n_points_max=1024, n_ds_max=256,
        n_imu_max=32, map_h_log2=9, map_bucket_slots=16, det_range=40.0,
        cube_side_length=300.0)
    return Scale(cfg, sim.SimConfig(duration=0.7, n_rings=8, n_azimuth=64,
                                    elev_min=-22.5, elev_max=22.5),
                 scans=6, warm=2, profile=0, ckpt_at=4, jax_ref=None)


def default_ranks() -> int:
    """The largest power of two not above the cards present, at most 4."""
    n = 1
    while 2 * n <= min(torch.cuda.device_count(), MAX_RANKS):
        n *= 2
    return n


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"multicard check failed: {msg}")


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest(a: np.ndarray) -> str:
    """A short hash of an array's bits (two runs equal bit for bit have the
    same)."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _positions(pipe) -> np.ndarray:
    return np.stack([p for _, p, _ in pipe.get_trajectory()])


def _ckpt_path(outdir, rank: int) -> Path:
    return Path(outdir) / f"multicard_rank{rank}.npz"


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


IF_PROBE_FLAGS = (True, False, True, True, False)


def if_node_rank(group) -> dict:
    """On a card: an ``all_reduce_sum`` and an ``all_gather`` of the group
    recorded inside one IF node body (``kernels.graph_if.record_if``) of a
    captured graph, replayed with each predicate of ``IF_PROBE_FLAGS`` (the
    same on every rank) and a new input each replay: what the gated
    sharded step needs of NCCL and the graph.  Returns per replay whether
    the outputs are the collectives' where the predicate held and untouched
    where it did not, and the traceback where recording or a replay
    raised."""
    from ..kernels import graph_if

    dev, world = group.device, group.world

    def value(k, rank):
        return torch.arange(4, dtype=torch.float32, device=dev) + 10 * k + rank

    x = value(0, group.rank)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    summed = torch.zeros(4, device=dev)
    gathered = torch.zeros((world, 4), device=dev)
    group.all_reduce_sum(x)  # the communicator, made before the capture
    group.all_gather(x)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()

    def body():
        summed.copy_(group.all_reduce_sum(x * 2))
        gathered.copy_(group.all_gather(x + 1))

    try:
        with torch.cuda.graph(graph):
            graph_if.record_if(flag, body)
    except RuntimeError:
        return dict(error=traceback.format_exc(), replays=[])
    replays = []
    for k, f in enumerate(IF_PROBE_FLAGS, start=1):
        x.copy_(value(k, group.rank))
        summed.fill_(-1.0)
        gathered.fill_(-1.0)
        flag.fill_(f)
        try:
            group.launching("graph")
            graph.replay()
            torch.cuda.synchronize(dev)
        except RuntimeError:
            return dict(error=traceback.format_exc(), replays=replays)
        peers = torch.stack([value(k, r) for r in range(world)])
        ok = (torch.equal(summed, 2 * peers.sum(0)) and torch.equal(
            gathered, peers + 1)) if f else (
            bool((summed == -1).all()) and bool((gathered == -1).all()))
        replays.append(dict(flag=f, ok=bool(ok)))
    del graph
    torch.cuda.synchronize(dev)
    return dict(error=None, replays=replays)


def if_node_row(probes: list, name: str) -> dict:
    """Log the probe's row from every rank's ``if_node_rank``, then check
    it: recorded, and every replay right on every rank."""
    row = {"phase": name, "ranks": len(probes),
           "errors": [p["error"] for p in probes],
           "replays_ok_by_rank": [[r["ok"] for r in p["replays"]]
                                  for p in probes],
           "flags": list(IF_PROBE_FLAGS)}
    log(row)
    for p in probes:
        check(p["error"] is None, f"{name}: {p['error']}")
        check([r["flag"] for r in p["replays"]] == list(IF_PROBE_FLAGS)
              and all(r["ok"] for r in p["replays"]),
              f"{name}: replays {p['replays']}")
    return row


WHILE_PROBE_PASSES = (1, 3, 5)
WHILE_PROBE_MAX_ITER = 7  # the index would end the loop after 8 passes


def while_node_rank(group) -> dict:
    """On a card: an ``all_reduce_sum`` and an ``all_gather`` of the group
    recorded inside the body of one WHILE node
    (``kernels.graph_if.record_while``) of a captured graph, replayed with
    ``done`` set after each count of passes of ``WHILE_PROBE_PASSES`` (the
    same on every rank) and a new input each replay: the collectives run
    several times a replay, as in the gated sharded step's filter loop.
    Returns per replay whether the outputs are the passes' sums and the
    device's count of passes is the count asked for, and the traceback
    where recording or a replay raised."""
    from ..kernels import graph_if

    dev, world = group.device, group.world

    def value(k, rank):
        return torch.arange(4, dtype=torch.float32, device=dev) + 10 * k + rank

    x = value(0, group.rank)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stop = torch.zeros((), dtype=torch.int32, device=dev)
    passes = torch.zeros(1, dtype=torch.int64, device=dev)
    summed = torch.zeros(4, device=dev)
    gathered = torch.zeros((world, 4), device=dev)
    group.all_reduce_sum(x)  # the communicator, made before the capture
    group.all_gather(x)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()

    def body():
        summed.add_(group.all_reduce_sum(x * 2))
        gathered.add_(group.all_gather(x + 1))
        i.add_(1)
        done.copy_(i + 1 >= stop)

    try:
        with torch.cuda.graph(graph):
            graph_if.record_while(done.reshape(1), i.reshape(1),
                                  WHILE_PROBE_MAX_ITER, body, passes)
    except RuntimeError:
        return dict(error=traceback.format_exc(), replays=[])
    replays = []
    for k, n in enumerate(WHILE_PROBE_PASSES, start=1):
        x.copy_(value(k, group.rank))
        i.fill_(-1)
        done.fill_(False)
        stop.fill_(n)
        passes.zero_()
        summed.zero_()
        gathered.zero_()
        try:
            group.launching("graph")
            graph.replay()
            torch.cuda.synchronize(dev)
        except RuntimeError:
            return dict(error=traceback.format_exc(), replays=replays)
        peers = torch.stack([value(k, r) for r in range(world)])
        ok = (torch.equal(summed, n * 2 * peers.sum(0))
              and torch.equal(gathered, n * (peers + 1))
              and int(passes[0]) == n and int(i) == n - 1)
        replays.append(dict(passes=n, passes_device=int(passes[0]),
                            ok=bool(ok)))
    del graph
    torch.cuda.synchronize(dev)
    return dict(error=None, replays=replays)


def while_node_row(probes: list, name: str) -> dict:
    """Log the probe's row from every rank's ``while_node_rank``, then
    check it: recorded, and every replay right on every rank."""
    row = {"phase": name, "ranks": len(probes),
           "errors": [p["error"] for p in probes],
           "replays_by_rank": [p["replays"] for p in probes],
           "passes": list(WHILE_PROBE_PASSES)}
    log(row)
    for p in probes:
        check(p["error"] is None, f"{name}: {p['error']}")
        check([r["passes"] for r in p["replays"]] == list(WHILE_PROBE_PASSES)
              and all(r["ok"] for r in p["replays"]),
              f"{name}: replays {p['replays']}")
    return row


def drive_modes_probed(group, *args) -> dict:
    """On a card, ``if_node_rank`` and ``while_node_rank`` first (under
    "if_node" and "while_node"; None on the CPU); then
    ``bench_scaling.drive_modes(group, *args)``."""
    card = group.device.type == "cuda"
    probes = dict(if_node=if_node_rank(group) if card else None,
                  while_node=while_node_rank(group) if card else None)
    return dict(bench_scaling.drive_modes(group, *args), **probes)


def ouster64_rank(group, scale: Scale) -> dict:
    """``drive_modes_probed`` on this rank: the probe on a card, then
    eager, then captured."""
    return drive_modes_probed(group, scale.cfg, scale.sim_cfg, scale.scans,
                              scale.warm, scale.profile)


def f64_rank(group, scale: Scale) -> dict:
    """The run in float64 through the sharded pipeline (captured on a
    card), and on rank 0 through the unsharded one on the same card."""
    cfg = dataclasses.replace(scale.cfg, compute_dtype="float64")
    data = sim.generate(scale.sim_cfg)
    pipe, fig = bench_scaling.drive_data(group, cfg, data, scale.scans,
                                         scale.warm)
    out = dict(positions=fig["positions"], graphs=fig["graphs"],
               scans_per_s=fig["scans_per_s"],
               launches_f64=fig["launches_f64"], launches=fig["launches"],
               dtype=str(pipe.x.pos.dtype), health=fig["health"],
               iterations=fig["iterations"])
    if group.rank == 0:
        single = Pipeline(cfg, device=group.device)
        for _ in bench_scaling.run_scans(single, data, scale.scans):
            pass
        out.update(unsharded=_positions(single), unsharded_graphs=(
            None if single.graphs is None else single.graphs.stats()),
                   unsharded_iterations=[int(d.iterations)
                                         for d in single.diags])
    return out


def checkpoint_rank(group, scale: Scale, outdir: str) -> dict:
    """The run through the sharded pipeline, a checkpoint written after
    ``scale.ckpt_at`` scans (a collective: every rank writes the global map
    to its own file), and on to the end."""
    data = sim.generate(scale.sim_cfg)
    pipe = Pipeline(scale.cfg, group=group)
    for k in bench_scaling.run_scans(pipe, data, scale.scans):
        if k + 1 == scale.ckpt_at:
            ckpt.save_pipeline(_ckpt_path(outdir, group.rank), pipe)
    traj = pipe.get_trajectory()
    return dict(stamps=[t for t, _, _ in traj], positions=_positions(pipe))


def rank_phases(group, scale: Scale, outdir: str) -> dict:
    """Every phase of the first launch, on this rank."""
    return dict(dryrun=sharding.dryrun_rank(group),
                ouster64=ouster64_rank(group, scale),
                f64=f64_rank(group, scale),
                checkpoint=checkpoint_rank(group, scale, outdir))


def resume_rank(group, scale: Scale, outdir: str) -> dict:
    """A fresh rank: the checkpoint of ``checkpoint_rank`` loaded, the rest
    of the run (captured on a card); then the same checkpoint into a
    pipeline sharded twice as many ways, which refuses it."""
    path = _ckpt_path(outdir, group.rank)
    data = sim.generate(scale.sim_cfg)
    pipe = Pipeline(scale.cfg, group=group)
    ckpt.load_pipeline(path, pipe)
    for _ in bench_scaling.run_scans(pipe, data, scale.scans, scale.ckpt_at):
        pass
    traj = pipe.get_trajectory()
    wider = dataclasses.replace(group, world=2 * group.world)
    try:
        ckpt.load_pipeline(path, Pipeline(scale.cfg, group=wider))
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(stamps=[t for t, _, _ in traj], positions=_positions(pipe),
                graphs=None if pipe.graphs is None else pipe.graphs.stats(),
                other_world_refused=refused)


# ---------------------------------------------------------------------------
# the rows and their checks (in the parent)
# ---------------------------------------------------------------------------


def _health_checks(name, hc, scale: Scale) -> None:
    check(not hc["nan"], f"{name}: NaN in the state")
    check(hc["p_min_eig"] > 0.0, f"{name}: covariance not positive definite")
    check(hc["truncated_points"] == 0, f"{name}: scan points truncated")
    if scale.jax_ref is not None:
        ref = scale.jax_ref["dropped"]
        check(abs(hc["map_dropped"] - ref) <= DROPPED_SLACK * ref,
              f"{name}: {hc['map_dropped']} global map drops, JAX {ref}")


def _ate_checks(name, fig, scale: Scale) -> None:
    check(np.isfinite(fig["positions"]).all(), f"{name}: positions not finite")
    if scale.jax_ref is not None:
        for key, ref in zip(("ate_raw_m", "ate_aligned_m"),
                            scale.jax_ref["ate_m"]):
            check(fig[key] <= ref + ATE_SLACK_M,
                  f"{name}: {key} {fig[key]} > JAX {ref} + {ATE_SLACK_M}")


def _same_on_every_rank(name, figs) -> None:
    f0 = figs[0]
    check(all(np.array_equal(f["positions"], f0["positions"])
              and f["stamps"] == f0["stamps"] and f["health"] == f0["health"]
              for f in figs), f"{name}: the ranks' trajectories differ")


def _profile_row(fig) -> Optional[dict]:
    prof = fig.get("profile")
    if prof is None:
        return None
    keys = ("wall_ms_per_scan", "device_busy_ms_per_scan",
            "device_idle_share", "device_activities_per_scan",
            "host_syncs_per_scan", "knn_kernel_ms_per_scan",
            "knn_search_launches_per_scan", "collective_kernels_per_scan")
    return {**{k: prof[k] for k in keys}, **fig["executed"]}


def dryrun_row(ranks: list) -> dict:
    """Log the dry run's row (``sharding.dryrun_row``; each rank checked
    the JAX package's bounds itself), then check that the ranks agree."""
    row = sharding.dryrun_row(ranks)
    log(row)
    check(row["ranks_agree"], "dryrun: the ranks' sharded figures differ")
    return row


def ouster64_row(ranks: list, scale: Scale, name: str, card: str) -> dict:
    """Log the ouster64 phase's row from every rank's ``ouster64_rank``
    result, then check it (raises on a failed check).  Returns the row."""
    on_card = ranks[0]["captured"]["graphs"] is not None
    cap0, eager0 = ranks[0]["captured"], ranks[0]["eager"]
    steps = len(cap0["stamps"])
    d_eager = float(np.abs(cap0["positions"] - eager0["positions"]).max())
    row = {
        "phase": name, "ranks": len(ranks), "transport": cap0["transport"],
        "captured": on_card, "scans": scale.scans, "steps": steps,
        "scans_per_s": {mode: [r[mode]["scans_per_s"] for r in ranks]
                        for mode in ("captured", "eager")},
        "profile_per_scan_by_rank": {
            mode: [_profile_row(r[mode]) for r in ranks]
            for mode in ("captured", "eager")},
        "knn_launches_by_rank": {
            mode: [{f"r{k}": n for k, n in r[mode]["launches"].items()}
                   for r in ranks] for mode in ("captured", "eager")},
        "graphs_by_rank": [
            None if r["captured"]["graphs"] is None else
            {str(k): v for k, v in r["captured"]["graphs"].items()}
            for r in ranks],
        "ate_raw_m": cap0["ate_raw_m"], "ate_aligned_m": cap0["ate_aligned_m"],
        "jax_ate_m": None if scale.jax_ref is None else scale.jax_ref["ate_m"],
        "health": cap0["health"],
        "jax_map_dropped": (None if scale.jax_ref is None
                            else scale.jax_ref["dropped"]),
        "iterations_mean": cap0["iterations_mean"],
        # the gated graph's collectives a scan, the same on every rank
        "collectives_equal_on_every_rank": all(
            _collectives(r["captured"]) == _collectives(cap0) for r in ranks),
        "ranks_bit_identical": all(
            np.array_equal(r[m]["positions"], ranks[0][m]["positions"])
            for r in ranks for m in ("captured", "eager")),
        "max_pos_diff_captured_vs_eager_m": d_eager, "tol_m": POS_TOL_M,
        # rank 0's positions' bits, to hold two runs to each other
        "positions_digest": {m: digest(cap0["positions"] if m == "captured"
                                       else eager0["positions"])
                             for m in ("captured", "eager")},
        "stage_times_s_by_rank": [r["stage_times"] for r in ranks],
        "pose_covariance_diag": np.diag(ranks[0]["pose_covariance"]).tolist(),
        "card": card,
    }
    if on_card:
        if_node_row([r["if_node"] for r in ranks], f"{name}_if_node_probe")
        while_node_row([r["while_node"] for r in ranks],
                       f"{name}_while_node_probe")
    log(row)
    for mode in ("captured", "eager"):
        figs = [r[mode] for r in ranks]
        _same_on_every_rank(f"{name} {mode}", figs)
        _health_checks(f"{name} {mode}", figs[0]["health"], scale)
        _ate_checks(f"{name} {mode}", figs[0], scale)
        for f in figs:  # the CPU runs the plain search, which counts none
            check(not on_card or (f["launches"][8] > 0
                                  and f["launches"][27] > 0),
                  f"{name} {mode}: rank {f['rank']} launched {f['launches']}")
    check(steps >= scale.scans - 2, f"{name}: {steps} estimates")
    check(d_eager <= POS_TOL_M,
          f"{name}: captured and eager positions differ {d_eager} m")
    check(row["collectives_equal_on_every_rank"],
          f"{name}: the ranks ran other collectives a scan")
    for r in ranks:
        cap, eager = r["captured"], r["eager"]
        # the gated graph skips passes and re-searches the eager step runs
        check(all(cap["launches"][k] <= eager["launches"][k]
                  for k in eager["launches"]),
              f"{name}: rank {cap['rank']} launched {cap['launches']} "
              f"captured, {eager['launches']} eager")
        check(all(v > 0 for v in r["stage_times"].values()),
              f"{name}: rank {cap['rank']} stage times {r['stage_times']}")
        cov = r["pose_covariance"]
        check(np.isfinite(cov).all() and np.allclose(cov, cov.T)
              and np.linalg.eigvalsh(cov).min() > 0,
              f"{name}: rank {cap['rank']} pose covariance {cov.tolist()}")
        if not on_card:
            continue
        graphs = cap["graphs"]
        replays = sum(g["replays"] for g in graphs.values())
        check(eager["graphs"] is None and 1 <= len(graphs) <= len(
            cap["pad_buckets"]) and replays == steps - len(graphs),
              f"{name}: rank {cap['rank']}: not one graph per pad bucket "
              f"replayed for the other {steps} steps ({graphs})")
        for mode in ("captured", "eager"):
            prof = r[mode]["profile"]
            check(prof["host_syncs_per_scan"] == 0,
                  f"{name} {mode}: rank {cap['rank']} "
                  f"{prof['host_syncs_per_scan']} host syncs a scan")
        # one rank's collectives are copies; across cards, NCCL kernels,
        # fewer where the gates skip passes and re-searches
        coll = [r[mode]["profile"]["collective_kernels_per_scan"]
                for mode in ("captured", "eager")]
        check(all(coll[0][k] <= coll[1][k] for k in coll[1])
              and (len(ranks) == 1 or min(coll[0].values()) > 0),
              f"{name}: rank {cap['rank']} collectives' kernels a scan "
              f"{coll[0]} captured, {coll[1]} eager")
        ex = cap["executed"]
        check(ex["knn_search_launches_counted_per_scan"]
              == r["captured"]["profile"]["knn_search_launches_per_scan"],
              f"{name}: rank {cap['rank']} kNN launches counted {ex}, "
              f"profiled {r['captured']['profile']}")
    return row


def _collectives(fig) -> Optional[dict]:
    """The NCCL kernels a scan of a profiled run (None off a card)."""
    prof = fig.get("profile")
    return None if prof is None else prof["collective_kernels_per_scan"]


def f64_row(ranks: list, name: str) -> dict:
    """Log the float64 phase's row, then check it: the ranks bit-identical,
    each position within ``F64_TOL_M`` of the unsharded run's."""
    r0 = ranks[0]
    on_card = r0["graphs"] is not None
    diff = np.abs(r0["positions"] - r0["unsharded"])
    row = {"phase": name, "ranks": len(ranks), "dtype": r0["dtype"],
           "scans": len(r0["positions"]),
           "graphs_by_rank": [None if r["graphs"] is None else
                              {str(k): v for k, v in r["graphs"].items()}
                              for r in ranks],
           "unsharded_graphs": None if r0["unsharded_graphs"] is None else
           {str(k): v for k, v in r0["unsharded_graphs"].items()},
           "knn_f64_launches_by_rank": [
               {f"r{k}": n for k, n in r["launches_f64"].items()}
               for r in ranks],
           "scans_per_s_synced": [r["scans_per_s"] for r in ranks],
           "max_pos_diff_vs_unsharded_m": float(diff.max()),
           "worst_scan": int(np.argmax(diff.max(axis=1))),
           "tol_m": F64_TOL_M, "health": r0["health"],
           # the gated passes a scan (the iterations), the unsharded
           # step's on the scans where it updates (not the first: the
           # sharded step updates then too, finding no point in the empty
           # map, as JAX's sharded step does)
           "iterations_equal_unsharded": all(
               len(r["iterations"]) == len(r0["unsharded_iterations"])
               and all(a == b for a, b in zip(r["iterations"],
                                              r0["unsharded_iterations"])
                       if b > 0) for r in ranks),
           "iterations_mean": float(np.mean(r0["iterations"])),
           "positions_digest": digest(r0["positions"])}
    log(row)
    check(row["iterations_equal_unsharded"],
          f"{name}: the passes a scan differ from the unsharded run's")
    check(r0["dtype"] == "torch.float64", f"{name}: {r0['dtype']}")
    check(all(np.array_equal(r["positions"], r0["positions"]) for r in ranks),
          f"{name}: the ranks' trajectories differ")
    check(all(r["launches_f64"][8] > 0 and r["launches_f64"][27] > 0
              and sum(r["launches"].values()) == 0 for r in ranks)
          or not on_card,
          f"{name}: not the float64 kernels at R = 8 and 27 alone")
    check(r0["positions"].shape == r0["unsharded"].shape
          and np.isfinite(r0["positions"]).all(),
          f"{name}: {r0['positions'].shape} positions, unsharded "
          f"{r0['unsharded'].shape}")
    check(diff.max() <= F64_TOL_M,
          f"{name}: {diff.max()} m from the unsharded float64 run")
    return row


def checkpoint_row(saved: list, resumed: list, name: str) -> dict:
    """Log the checkpoint phase's row, then check it: the resumed ranks
    bit-identical, within ``POS_TOL_M`` of the uninterrupted run, and the
    checkpoint refused by a pipeline sharded twice as many ways."""
    s0, r0 = saved[0], resumed[0]
    n = len(r0["stamps"])
    check(n > 0 and s0["stamps"][-n:] == r0["stamps"],
          f"{name}: resumed stamps {r0['stamps']} are not the run's last")
    diff = float(np.abs(s0["positions"][-n:] - r0["positions"]).max())
    row = {"phase": name, "ranks": len(resumed), "resumed_scans": n,
           "graphs_by_rank": [None if r["graphs"] is None else
                              {str(k): v for k, v in r["graphs"].items()}
                              for r in resumed],
           "max_pos_diff_vs_uninterrupted_m": diff, "tol_m": POS_TOL_M,
           "other_world_refused": r0["other_world_refused"]}
    log(row)
    check(all(np.array_equal(r["positions"], r0["positions"])
              for r in resumed), f"{name}: the resumed ranks differ")
    check(diff <= POS_TOL_M, f"{name}: resumed {diff} m from the "
          "uninterrupted run")
    check(all(r["other_world_refused"] is not None
              and "sharded" in r["other_world_refused"] for r in resumed),
          f"{name}: a pipeline of another rank count took the checkpoint")
    return row


def card_name() -> str:
    """The card's name and power limit from nvidia-smi (``"cpu"`` on CPU
    ranks)."""
    from .microbench_knn import card

    return card() if torch.cuda.is_available() else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks, one card each (default: the largest power "
                         f"of two not above the cards, at most {MAX_RANKS})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: rehearse on gloo CPU ranks at a tiny size")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("multicard: no CUDA device; nothing run (--device cpu "
              "rehearses on the CPU)", file=sys.stderr)
        return 1
    n = args.ranks or (default_ranks() if on_card else MAX_RANKS)
    backend, device = ("nccl", None) if on_card else ("gloo", "cpu")
    scale = full_scale() if on_card else tiny_scale()
    card = card_name()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="multicard_") as tmp:
        ranks = launch(rank_phases, n, args=(scale, tmp), backend=backend,
                       device=device, timeout_s=900.0)
        resumed = launch(resume_rank, n, args=(scale, tmp), backend=backend,
                         device=device, timeout_s=600.0)
    failed = []

    def row(fn, *args):
        """Log the phase's row; keep its failed check, so that every row
        is printed before the run fails."""
        try:
            return fn(*args)
        except RuntimeError as e:
            failed.append(str(e))
            return None

    rows = [row(dryrun_row, [r["dryrun"] for r in ranks]),
            row(ouster64_row, [r["ouster64"] for r in ranks], scale,
                "sharded_ouster64_ranks", card),
            row(f64_row, [r["f64"] for r in ranks],
                "sharded_ouster64_ranks_f64"),
            row(checkpoint_row, [r["checkpoint"] for r in ranks], resumed,
                "checkpoint_ranks")]
    if failed:
        raise RuntimeError("\n".join(failed))
    log({"multicard": "ok", "ranks": n, "transport": rows[1]["transport"],
         "phases": [r["phase"] for r in rows],
         "seconds": time.perf_counter() - t0, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
