#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fast_lio_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. build — compile every CUDA kernel of the port from ``csrc/`` (nvcc, one
   process per source, all started together) and print the build time.
2. kernels — hold each kernel against its plain PyTorch version on the card,
   at the shapes of the main path: the kNN search with R = 8 (H = 2^15,
   B = 64, N = 8192) and R = 27 (H = 2^15, B = 128, N = 2048), over a map
   filled from a few simulated scans.  Rule (tests/test_knn_pallas.py:33-56):
   found masks equal, squared distances within rtol 1e-5, neighbours equal
   wherever the distances are distinct.  Times: CUDA events, median of 25.
3. small — the port's pipeline on CUDA against its own CPU path (the plain
   versions) on a small sim: per-scan positions within 5 mm.
4. avia — the main path at the AVIA preset's full size (32768-point pad,
   8192 downsampled points, 2^15 x 64-slot map): 30 simulated scans through
   ``Pipeline.push_imu/push_lidar/spin_once``.  Checks: the R = 8 kernel ran,
   no NaN, a positive definite covariance, no truncated scan, no more map
   drops than the JAX package's on the same run (none), ATE within 1 cm of
   its ATE.
5. ouster64 — the OUSTER64 preset (n_points_max 45056, 2^15 x 128-slot map,
   wide fallback with partial-wide compaction): 20 scans.  Checks: the R = 27
   kernel ran, and the checks of phase 4, with map drops within 10% of the
   JAX package's (it drops 307 points on this run).

Output: JSON lines per phase; then the ``kernels`` line, the card's name and
power limit from nvidia-smi, and last ``{"ok": true, "device": {...}}``.
Needs one CUDA device; prints no result and exits 1 without one, or when run
outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# The JAX package's ATE (raw, aligned) and map drops on the runs of phases 4
# and 5 (same presets, same sim data), computed once on a CPU by
# tests/torch_reference_ate.py.
JAX_ATE_M = {
    "avia": (0.03469561611056514, 0.013552656768317909),
    "ouster64": (0.03198349476697826, 0.01154589455923144),
}
JAX_MAP_DROPPED = {"avia": 0, "ouster64": 307}
ATE_SLACK_M = 0.01
# which points overflow a full bucket depends on f32 rounding of the poses,
# so the port's drop count may differ a little from the JAX package's
DROPPED_SLACK = 0.1

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
SQ_RTOL, SQ_ATOL = 1e-5, 1e-6
SMALL_POS_TOL_M = 5e-3
TIMING_REPS = 25


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() in ms (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def knn_case(pkg, map_cfg, sim_cfg, n_queries, wide, seed):
    """A map filled from 5 simulated scans (world frame) and n_queries
    jittered points of the 6th, all on the card."""
    hm, simlib = pkg["hm"], pkg["sim"]
    dev = torch.device("cuda")
    data = simlib.generate(sim_cfg)
    m = hm.make_map(map_cfg, torch.float32, dev)
    for k in range(5):
        pw = data.scans[k] @ data.gt_rot[k].T + data.gt_pos[k]
        p = torch.tensor(pw, dtype=torch.float32, device=dev)
        on = torch.ones(len(p), dtype=torch.bool, device=dev)
        m = hm.insert(m, map_cfg, p, on, on)
    q = data.scans[5] @ data.gt_rot[5].T + data.gt_pos[5]
    q = np.resize(q, (n_queries, 3))  # repeats the scan if it is short
    q = q + np.random.default_rng(seed).normal(0.0, 0.05, q.shape)
    return m, torch.tensor(q, dtype=torch.float32, device=dev)


def knn_bound(hm, m, map_cfg, queries, wide):
    """Least time for this run's data: each distinct bucket row read once
    (plus queries and outputs) at the HBM rate, or ~15 f32 operations per
    live candidate slot (1 per free slot) at the f32 rate; the larger."""
    B = map_cfg.bucket_slots
    N = queries.shape[0]
    _base, cells, R = hm.region_cells(queries, map_cfg, wide)
    buckets = torch.sort(hm._bucket_of(cells, map_cfg.h_log2), dim=-1).values
    distinct = torch.cat([torch.ones_like(buckets[:, :1], dtype=torch.bool),
                          buckets[:, 1:] != buckets[:, :-1]], dim=-1)
    live_per_bucket = hm.valid_mask(m).sum(dim=1)
    live = int((live_per_bucket[buckets] * distinct).sum())
    slots = int(distinct.sum()) * B
    n_rows = int(torch.unique(buckets).numel())
    nbytes = n_rows * 4 * B * 4 + N * 12 + N * 5 * (12 + 4 + 1)
    ops = 15 * live + (slots - live)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    rows_model = (N * R * 4 * B * 4 + N * 12 + N * 85) / H100_HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            rows_model)


def compare_knn(got, ref):
    """The tests/test_knn_pallas.py rule; returns max |Δsq| over found."""
    nb_k, sq_k, f_k = got
    nb_p, sq_p, f_p = ref
    check(torch.equal(f_k, f_p), "kNN found masks differ")
    sk = torch.where(f_p, sq_k, torch.zeros_like(sq_k))
    sp = torch.where(f_p, sq_p, torch.zeros_like(sq_p))
    err = torch.abs(sk - sp)
    check(bool((err <= SQ_ATOL + SQ_RTOL * torch.abs(sp)).all()),
          f"kNN squared distances differ (max {float(err.max())})")
    # neighbours must match wherever the distance is not tied
    tied = (torch.abs(sq_p[:, :, None] - sq_p[:, None, :]) < 1e-9).sum(-1) > 1
    strict = f_p & ~tied
    nerr = torch.abs(nb_k - nb_p).amax(-1)
    check(bool((nerr[strict] <= 1e-6 + 1e-6 * torch.abs(nb_p).amax(-1)[strict]).all()),
          "kNN neighbours differ where distances are distinct")
    return float(err.max())


def phase_kernels(pkg):
    hm, knn, simlib = pkg["hm"], pkg["knn"], pkg["sim"]
    avia_sim = simlib.SimConfig(duration=0.75, n_rings=32, n_azimuth=400)
    ouster_sim = simlib.SimConfig(duration=0.75, n_rings=64, n_azimuth=688,
                                  elev_min=-22.5, elev_max=22.5)
    cases = [
        ("knn_r8", hm.make_config(0.5, h_log2=15, cell_multiplier=4),
         avia_sim, 8192, False),
        ("knn_r27", hm.make_config(0.5, h_log2=15, cell_multiplier=5),
         ouster_sim, 2048, True),
    ]
    rows = {}
    for i, (name, map_cfg, sim_cfg, n, wide) in enumerate(cases):
        m, q = knn_case(pkg, map_cfg, sim_cfg, n, wide, seed=i)
        got = knn.knn_search_cuda(m.packed, map_cfg, q, wide=wide)
        ref = hm.knn_search(m, map_cfg, q, wide=wide)
        torch.cuda.synchronize()
        err = compare_knn(got, ref)
        ms = cuda_ms(lambda: knn.knn_search_cuda(m.packed, map_cfg, q,
                                                        wide=wide))
        plain_ms = cuda_ms(lambda: hm.knn_search(m, map_cfg, q, wide=wide))
        bound_ms, bound_by, rows_model_ms = knn_bound(hm, m, map_cfg, q,
                                                      wide)
        rows[name] = dict(
            name=name, route="cuda", source="fast_lio_tpu_torch/csrc/knn.cu",
            replaces="tools/knn_pallas.py:193", launches=None,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            shape=dict(N=n, R=27 if wide else 8, B=map_cfg.bucket_slots,
                       H=map_cfg.num_buckets),
            found_frac=float(got[2].float().mean()),
            rows_model_bound_ms=rows_model_ms)
        log({"phase": "kernels", **rows[name]})
    return rows


# --------------------------------------------------------------------------
# phases 3-5: the pipeline
# --------------------------------------------------------------------------


def feed(pipe, data):
    """Push a sim run through the packet API; returns per-scan wall times."""
    imu_i = 0
    times = []
    for k in range(len(data.scans)):
        t0 = time.perf_counter()
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_small(pkg):
    cfg_mod, simlib, Pipeline = pkg["config"], pkg["sim"], pkg["Pipeline"]
    cfg = cfg_mod.Config(
        lidar_type=cfg_mod.LidarType.AVIA, filter_size_surf=0.3,
        filter_size_map=0.3, n_points_max=2048, n_ds_max=1024, n_imu_max=32,
        map_h_log2=12, det_range=40.0, cube_side_length=300.0)
    data = simlib.generate(simlib.SimConfig(duration=1.2, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))
    ref = Pipeline(cfg, device="cpu")
    feed(ref, data)
    gpu = Pipeline(cfg, device="cuda")
    feed(gpu, data)
    p_ref = np.stack([p for _, p, _ in ref.get_trajectory()])
    p_gpu = np.stack([p for _, p, _ in gpu.get_trajectory()])
    check(p_ref.shape == p_gpu.shape, "small: trajectory lengths differ")
    check(np.isfinite(p_gpu).all(), "small: non-finite positions")
    dmax = float(np.abs(p_ref - p_gpu).max())
    check(dmax <= SMALL_POS_TOL_M, f"small: CUDA vs CPU position {dmax} m")
    log({"phase": "small", "scans": len(p_gpu), "max_pos_diff_m": dmax,
         "tol_m": SMALL_POS_TOL_M})


def run_main_path(pkg, name, cfg, sim_cfg, warm_scans=5):
    """Drive one main path; checks the state is finite, the covariance
    positive definite and the ATE within ATE_SLACK_M of the JAX package's."""
    simlib, Pipeline, knn = pkg["sim"], pkg["Pipeline"], pkg["knn"]
    data = simlib.generate(sim_cfg)
    torch.cuda.reset_peak_memory_stats()
    pipe = Pipeline(cfg)  # CUDA by default
    for r in knn.launches:
        knn.launches[r] = 0
    times = feed(pipe, data)
    launches = dict(knn.launches)
    traj = pipe.get_trajectory()
    hc = pipe.health_check()
    steady = times[warm_scans:]
    out = {
        "phase": name, "scans": len(traj),
        "pts_per_scan": float(np.mean([len(s) for s in data.scans])),
        "scans_per_s": len(steady) / sum(steady),
        "scan_ms_median": 1e3 * statistics.median(steady),
        "first_scans_s": sum(times[:warm_scans]),
        "ate_raw_m": simlib.ate_rmse(traj, data),
        "ate_aligned_m": simlib.ate_rmse_aligned(traj, data),
        "knn_launches": {f"r{r}": n for r, n in launches.items()},
        "iterations_mean": float(np.mean([int(d.iterations) for d in pipe.diags])),
        "n_effective_last": int(pipe.diags[-1].n_effective),
        "health": hc,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(out)
    check(not hc["nan"], f"{name}: NaN in the state")
    check(hc["p_min_eig"] > 0.0, f"{name}: covariance not positive definite")
    check(hc["truncated_points"] == 0, f"{name}: scan points truncated")
    ref_dropped = JAX_MAP_DROPPED[name]
    check(hc["map_dropped"] <= ref_dropped * (1 + DROPPED_SLACK),
          f"{name}: {hc['map_dropped']} map drops, JAX {ref_dropped}")
    for key, ref in zip(("ate_raw_m", "ate_aligned_m"), JAX_ATE_M[name]):
        check(out[key] <= ref + ATE_SLACK_M,
              f"{name}: {key} {out[key]} > JAX {ref} + {ATE_SLACK_M}")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "fast_lio_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    from fast_lio_tpu_torch import config, sim
    from fast_lio_tpu_torch.kernels import build
    from fast_lio_tpu_torch.kernels import knn
    from fast_lio_tpu_torch.map import hash_map as hm
    from fast_lio_tpu_torch.pipeline import Pipeline

    pkg = dict(config=config, sim=sim, hm=hm, knn=knn, Pipeline=Pipeline)
    card = gpu_name_and_power()

    # 1. build
    t0 = time.perf_counter()
    paths = build.build_all(["knn"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in paths.values()
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log({"phase": "build", "seconds": build_s, "card": card, "ptxas": ptxas})

    # 2. kernels vs plain versions
    kernel_rows = phase_kernels(pkg)

    # 3. small: CUDA path vs the CPU path
    phase_small(pkg)

    # 4. avia at the preset's full size
    avia_sim = sim.SimConfig(duration=3.0, n_rings=32, n_azimuth=400)
    avia, l_avia = run_main_path(pkg, "avia", config.PRESETS["avia"],
                                 avia_sim)
    check(l_avia[8] > 0, "avia: the R=8 kNN kernel never ran")

    # 5. ouster64 (bench.py's 45056-point pad)
    ouster_cfg = dataclasses.replace(config.PRESETS["ouster64"],
                                     n_points_max=45056)
    ouster_sim = sim.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                               elev_min=-22.5, elev_max=22.5)
    _, l_ouster = run_main_path(pkg, "ouster64", ouster_cfg,
                                      ouster_sim)
    check(l_ouster[27] > 0, "ouster64: the R=27 kNN kernel never ran")

    for name, r in (("knn_r8", 8), ("knn_r27", 27)):
        kernel_rows[name]["launches"] = l_avia[r] + l_ouster[r]
        kernel_rows[name]["launches_by_path"] = {"avia": l_avia[r],
                                                 "ouster64": l_ouster[r]}
    log({"kernels": list(kernel_rows.values())})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
