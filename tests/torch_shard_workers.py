"""What the ranks of the port's sharding tests run (``parallel.launch``
pickles these functions by name, so each rank imports this module): torch,
numpy and the port only, no JAX.  The inputs are built here with numpy, the
same for the JAX side of the tests (``tests/test_torch_sharding.py``,
``tests/test_torch_distributed.py``)."""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import convert as tconvert
from fast_lio_tpu_torch import imu as timu
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.filter import process as tprocess
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import ShardGroup
from fast_lio_tpu_torch.parallel import sharding as tshd
from fast_lio_tpu_torch.utils import checkpoint as tckpt

DT = torch.float64

# ---------------------------------------------------------------------------
# tests/test_sharding.py's step cases
# ---------------------------------------------------------------------------

CASES = {  # id -> (knn_wide_fallback, knn_wide_max_queries)
    "standard": (False, 2048),
    "wide_fallback": (True, 2048),
    "wide_partial_compaction": (True, 64),
    "wide_overflow": (True, 2),
}
N_NEAR, N_FAR = 80, 8  # kNN queries near map points, and above the floor


def step_cfg(wide: bool, wmax: int) -> dict:
    """Config keywords of tests/test_sharding.py (the map config is
    ``step_map_cfg``)."""
    return dict(n_points_max=2048, n_ds_max=1024, n_imu_max=16,
                map_h_log2=12, map_bucket_slots=8, filter_size_surf=0.3,
                filter_size_map=0.3, knn_backend="xla",
                knn_wide_fallback=wide, knn_wide_max_queries=wmax)


def step_map_cfg() -> dict:
    """hash_map.make_config keywords: 64 slots, a full 4x4x4-voxel cell."""
    return dict(voxel_size=0.3, h_log2=12, bucket_slots=64)


def step_inputs(n_points: int, n_imu: int, seed: int) -> tuple:
    """numpy inputs of one scan after the map and state (tests/
    test_sharding.py's box walls): imu_t, acc, gyr, imu_mask, acc_scale,
    last_end_rel, pcl_end_rel, pts, pt_time, pt_mask, intensity, lm_lo,
    lm_hi, lm_init, ekf_inited."""
    rng = np.random.default_rng(seed)
    M, N = n_imu, n_points
    imu_acc = (np.tile([0, 0, tst.S2_LENGTH], (M, 1))
               + rng.normal(size=(M, 3)) * 1e-3)
    imu_gyr = rng.normal(size=(M, 3)) * 0.02
    n_per = N // 3
    u = rng.uniform(-8, 8, size=(n_per, 2))
    p1 = np.column_stack([u[:, 0], u[:, 1], np.zeros(n_per)])
    p2 = np.column_stack([np.full(n_per, 8.0), u[:, 0], 0.5 + 0.2 * u[:, 1]])
    p3 = np.column_stack([u[:, 0], np.full(n_per, -8.0), 0.5 + 0.2 * u[:, 1]])
    pts = np.concatenate([p1, p2, p3, np.zeros((N - 3 * n_per, 3))])
    return (np.linspace(0, 0.1, M), imu_acc, imu_gyr, np.ones(M, bool),
            1.0, 0.0, 0.1, pts, np.linspace(0, 0.1, N), np.arange(N) < 3 * n_per,
            np.zeros(N), np.full(3, -150.0), np.full(3, 150.0), True, True)


def initial_state_np() -> dict:
    """x0 (grav along -z), P0 = I, Q, IMU carry as numpy: the JAX test's."""
    x0 = tst.identity_state(DT)._replace(
        grav=torch.tensor([0.0, 0.0, -tst.S2_LENGTH], dtype=DT))
    return dict(x={f: v.numpy() for f, v in zip(x0._fields, x0)},
                P=np.eye(tst.DOF),
                Q=tprocess.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, DT).numpy())


def knn_queries(live_points: np.ndarray) -> np.ndarray:
    """N_NEAR queries 7 cm off live map points (tests/test_sharding.py's
    offset, drawn from the map by a seeded choice) and N_FAR 1 m above the
    floor, whose 5th neighbour lies beyond the narrow search's coverage:
    these leave the wide fallback work to do."""
    near = np.asarray(sorted(set(map(tuple, np.round(live_points, 5)))))
    near = near[np.random.default_rng(7).choice(len(near), N_NEAR, replace=False)]
    g = np.linspace(-6.0, 6.0, 4)
    far = np.stack(np.meshgrid(g, g, [1.0], indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([near + 0.07, far[:N_FAR]])


def _torch_inputs(ins, device):
    out = []
    for a in ins:
        a = np.asarray(a)
        out.append(torch.tensor(a, device=device) if a.dtype == bool
                   else torch.tensor(a, dtype=DT, device=device))
    # ekf_inited, a () bool tensor as Pipeline passes it
    out[-1] = torch.tensor(bool(ins[-1]), device=device)
    return out


def _state(init, device):
    x = tst.State(**{f: torch.tensor(v, dtype=DT, device=device)
                     for f, v in init["x"].items()})
    return (x, torch.tensor(init["P"], dtype=DT, device=device),
            timu.init_imu_carry(DT, device),
            torch.tensor(init["Q"], dtype=DT, device=device))


def _two_rounds(step, m, init, ins1, ins2, device, after_round1=None):
    """Round 1 inserts only, round 2 updates; ``after_round1(map)`` runs
    between them.  Returns (x, P, map, diag) of round 2."""
    x, P, carry, Q = _state(init, device)
    x, P, m, carry, _lm, _cl, _d = step(
        x, P, m, carry, Q, *_torch_inputs(ins1, device), do_update=False)
    if after_round1 is not None:
        after_round1(m)
    x, P, m, carry, _lm, _cl, d = step(
        x, P, m, carry, Q, *_torch_inputs(ins2, device), do_update=True)
    return x, P, m, d


def sharding_cases(group: ShardGroup, init, ins1, ins2) -> dict:
    """Every rank: each case of CASES on the whole group (round-1 global
    map, merged kNN on it, round-2 state); then ``sharding.dryrun_rank``;
    then, on rank 0 in a group of its own, each case at one rank against the
    port's unsharded ``lio_step`` (bit-equal or not)."""
    dev = group.device
    map_cfg = thm.make_config(**step_map_cfg())
    lcfg = tshd.local_map_cfg(map_cfg, group.world)
    out = {}
    for name, (wide, wmax) in CASES.items():
        cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **step_cfg(wide, wmax))
        seen = {}

        def after_round1(m_local):
            g = tshd.gather_global_map(m_local, group)
            q = torch.tensor(knn_queries(thm.flatten(g)), dtype=DT, device=dev)
            mask = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
            wide_sizes = []  # queries of each wide search: the arm taken
            search = tshd.knn_kernel.knn_search

            def counting(m, c, qq, k=5, wide=False):
                if wide:
                    wide_sizes.append(qq.shape[0])
                return search(m, c, qq, k=k, wide=wide)

            tshd.knn_kernel.knn_search = counting
            try:
                nb, sq, f = tshd.merged_knn(group, m_local, lcfg, q, 5,
                                            cfg=cfg, mask=mask)
            finally:
                tshd.knn_kernel.knn_search = search
            seen.update(wide_sizes=wide_sizes, packed=g.packed.cpu().numpy(),
                        dropped=g.dropped.cpu().numpy(), queries=q.cpu().numpy(),
                        nbrs=nb.cpu().numpy(), sq=sq.cpu().numpy(),
                        found=f.cpu().numpy())

        step = lambda *a, do_update: tshd.sharded_lio_step(  # noqa: E731
            cfg, map_cfg, group, *a, do_update=do_update)
        x, P, _m, d = _two_rounds(step, tshd.make_sharded_map(map_cfg, group, DT),
                                  init, ins1, ins2, dev, after_round1)
        out[name] = dict(seen, x={f: v.cpu().numpy() for f, v in zip(x._fields, x)},
                         P=P.cpu().numpy(), map_size=int(d["map_size"]),
                         n_eff=int(d["n_eff"]))
    out["dryrun"] = tshd.dryrun_rank(group)

    # one rank: a group of rank 0 alone (every rank creates every group)
    alone = [dist.new_group([r]) for r in range(group.world)]
    if group.rank == 0:
        one = ShardGroup(alone[0], 0, 1, dev, group.backend)
        out["one_rank"] = {}
        single = {}
        for name, (wide, wmax) in CASES.items():
            cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA,
                              **step_cfg(wide, wmax))
            xs, Ps, ms, ds = _two_rounds(
                lambda *a, do_update: tshd.sharded_lio_step(
                    cfg, map_cfg, one, *a, do_update=do_update),
                tshd.make_sharded_map(map_cfg, one, DT), init, ins1, ins2, dev)
            xu, Pu, mu, du = _two_rounds(
                lambda *a, do_update: tpipe.lio_step(
                    cfg, map_cfg, *a,
                    do_update=torch.tensor(do_update, device=dev)),
                thm.make_map(map_cfg, DT, dev), init, ins1, ins2, dev,
                lambda m: single.setdefault("packed", m.packed.cpu().numpy().copy()))
            out["one_rank"][name] = dict(
                x=all(torch.equal(a, b) for a, b in zip(xs, xu)),
                P=torch.equal(Ps, Pu), map=torch.equal(ms.packed, mu.packed),
                diag=[int(ds[k]) for k in ("n_eff", "iters", "map_size")]
                == [int(du[k]) for k in ("n_eff", "iters", "map_size")])
        # the insert-only round's map of the unsharded step (the same in
        # every case): the layout the 8 ranks' global map must equal
        out["single_round1_packed"] = single["packed"]
    return out


# ---------------------------------------------------------------------------
# tests/test_distributed.py's stream
# ---------------------------------------------------------------------------

N_SCANS = 12


def stream_sim_cfg() -> dict:
    return dict(duration=N_SCANS * 0.1 + 0.25, n_rings=8, n_azimuth=160,
                range_noise=0.01, imu_acc_noise=0.01, imu_gyr_noise=0.001)


def stream_cfg() -> dict:
    return dict(n_points_max=2048, n_ds_max=1024, n_imu_max=16,
                map_h_log2=10, map_bucket_slots=32, filter_size_surf=0.3,
                filter_size_map=0.3, det_range=40.0, cube_side_length=300.0,
                knn_backend="xla", compute_dtype="float64")


def feed(pipe, data) -> None:
    """tests/test_distributed.py's feed: every scan, IMU up to its end."""
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass


def feed_extra(pipe, data) -> None:
    """tests/test_distributed.py's one more scan: the last scan's points
    again, 0.1 s later, with the IMU samples of its period shifted too."""
    k = N_SCANS - 1
    stamp = data.scan_stamps[k] + 0.1
    for j in range(len(data.imu_t)):
        if data.scan_stamps[k] < data.imu_t[j] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[j] + 0.1, data.imu_acc[j], data.imu_gyr[j])
    pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
    while pipe.spin_once():
        pass


def distributed_run(group: ShardGroup, outdir: str, jax_ckpt: str) -> dict:
    """Every rank: the stream through ``Pipeline(group=...)``, a checkpoint
    to its own path and a resume, one more scan on both; then the JAX
    package's two-device checkpoint (written by the test while the ranks
    run) resumed and the same scan; and the refusals."""
    data = tsim.generate(tsim.SimConfig(**stream_sim_cfg()))
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **stream_cfg())
    pipe = tpipe.Pipeline(cfg, group=group)
    feed(pipe, data)
    traj = pipe.get_trajectory()
    hc = pipe.health_check()
    single_traj = None
    if group.rank == 0:  # the port's single-device run of the stream
        single = tpipe.Pipeline(cfg, device=group.device)
        feed(single, data)
        single_traj = np.stack([p for _, p, _ in single.get_trajectory()])

    path = Path(outdir) / f"dist_ckpt_{group.rank}.npz"
    tckpt.save_pipeline(path, pipe)
    pipe2 = tpipe.Pipeline(cfg, group=group)
    tckpt.load_pipeline(path, pipe2)
    ckpt_map_size_ok = pipe2.health_check()["map_size"] == hc["map_size"]
    for p in (pipe, pipe2):
        feed_extra(p, data)
    resume_exact = torch.equal(pipe.x.pos, pipe2.x.pos)

    deadline = time.monotonic() + 600.0
    while not Path(jax_ckpt).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {jax_ckpt}")
        time.sleep(0.2)
    pipe3 = tpipe.Pipeline(cfg, group=group)
    tckpt.load_pipeline(jax_ckpt, pipe3)
    # the same state through convert.load_numpy_state: the same table
    z = np.load(jax_ckpt)
    arrays = {k: z[k] for k in tconvert.DEVICE_ARRAYS if k in z.files}
    arrays.update({k: z[f"meta_{k}"] for k in tconvert.KEYS if k not in arrays})
    pipe4 = tpipe.Pipeline(cfg, group=group)
    tconvert.load_numpy_state(pipe4, arrays)
    numpy_state_same_map = (torch.equal(pipe4.map.packed, pipe3.map.packed)
                            and torch.equal(pipe4.map.dropped, pipe3.map.dropped))
    feed_extra(pipe3, data)

    refused = {}

    def refuses(what, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            refused[what] = f"{type(e).__name__}: {e}"

    refuses("rescore_research", lambda: tpipe.Pipeline(
        dataclasses.replace(cfg, rescore_research=True), group=group))
    refuses("device", lambda: tpipe.Pipeline(cfg, device=group.device,
                                             group=group))
    refuses("stage_timing", pipe3.measure_stage_times)
    single = path.with_name(f"single_{group.rank}.npz")
    tckpt.save_pipeline(single, tpipe.Pipeline(cfg, device=group.device))
    refuses("single_map_checkpoint", lambda: tckpt.load_pipeline(single, pipe3))
    return dict(
        rank=group.rank, transport=group.transport,
        traj=np.stack([p for _, p, _ in traj]), stamps=[t for t, _, _ in traj],
        single_traj=single_traj,
        map_size=hc["map_size"], nan=hc["nan"],
        ckpt_map_size_ok=ckpt_map_size_ok, resume_exact=resume_exact,
        next_pos=pipe.x.pos.cpu().numpy(),
        next_pos_from_jax=pipe3.x.pos.cpu().numpy(),
        numpy_state_same_map=numpy_state_same_map, refused=refused)


# ---------------------------------------------------------------------------
# on a card: one NCCL rank against the unsharded pipeline
# ---------------------------------------------------------------------------


def one_rank_against_unsharded(group: ShardGroup) -> dict:
    """A small sim run through the sharded pipeline on one rank and through
    the unsharded one on the same device: both trajectories."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
                      filter_size_map=0.3, n_points_max=2048, n_ds_max=1024,
                      n_imu_max=32, map_h_log2=12, det_range=40.0,
                      cube_side_length=300.0)
    data = tsim.generate(tsim.SimConfig(duration=1.2, n_rings=8, n_azimuth=200,
                                        range_noise=0.01))
    out = {}
    for name, pipe in (("sharded", tpipe.Pipeline(cfg, group=group)),
                       ("unsharded", tpipe.Pipeline(cfg, device=group.device))):
        feed(pipe, data)
        out[name] = np.stack([p for _, p, _ in pipe.get_trajectory()])
    out["device"] = str(group.device)
    out["transport"] = group.transport
    return out


def fails_on_rank_one(group: ShardGroup) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if group.rank == 1:
        raise ValueError("rank one gives up")
    group.all_reduce_sum(torch.ones(1))
