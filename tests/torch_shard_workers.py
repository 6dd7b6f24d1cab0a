"""What the ranks of the port's sharding tests run (``parallel.launch``
pickles these functions by name, so each rank imports this module): torch,
numpy and the port only, no JAX.  The inputs are built here with numpy, the
same for the JAX side of the tests (``tests/test_torch_sharding.py``,
``tests/test_torch_distributed.py``)."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import control_flow as tcf
from fast_lio_tpu_torch import convert as tconvert
from fast_lio_tpu_torch import imu as timu
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.filter import process as tprocess
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import ShardGroup
from fast_lio_tpu_torch.parallel import sharding as tshd
from fast_lio_tpu_torch.step_graph import StepGraphs
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


@contextlib.contextmanager
def host_branch_ifs(device, flags: list):
    """Within: a gated capture on ``device`` whose IF nodes are host
    branches (``if bool(pred): body``) and whose WHILE nodes are host
    loops (``while any lane is active: body``), each predicate and each
    evaluation of a loop's condition appended to ``flags``: the gated
    step's semantics where no graph records."""
    real = tcf._record_if, tcf._record_while

    def host_if(pred, fn):
        flags.append(bool(pred))
        if flags[-1]:
            fn()

    def host_while(done, i, max_iter, fn, active=None):
        while True:
            cond = ~done & (i < max_iter)
            if active is not None:
                active.copy_(cond)
            flags.append(bool(cond.any()))
            if not flags[-1]:
                return
            fn()

    tcf._record_if, tcf._record_while = host_if, host_while
    try:
        with tcf.gated_capture(device):
            yield
    finally:
        tcf._record_if, tcf._record_while = real


def same_on_every_rank(group: ShardGroup, flags: list) -> bool:
    """Whether every rank of ``group`` saw the sequence ``flags`` (one
    all-gather of the lengths, one of the flags)."""
    dev = group.device
    n = group.all_gather(torch.tensor([len(flags)], device=dev))
    if not bool((n == len(flags)).all()):
        return False
    seen = group.all_gather(torch.tensor(flags, dtype=torch.int32, device=dev))
    return bool((seen == seen[0]).all())


def sharding_cases(group: ShardGroup, init, ins1, ins2) -> dict:
    """Every rank: each case of CASES on the whole group (round-1 global
    map, merged kNN on it, round-2 state), masked, and again gated with its
    IF nodes host branches (``host_branch_ifs``), against the masked run
    (bit-equal or not) and its predicates against every rank's; then
    ``sharding.dryrun_rank``; then, on rank 0 in a group of its own, each
    case at one rank against the port's unsharded ``lio_step`` (bit-equal
    or not)."""
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
        x, P, m, d = _two_rounds(
            step, tshd.make_sharded_map(map_cfg, group, DT), init, ins1,
            ins2, dev, after_round1)
        flags = []
        with host_branch_ifs(dev, flags):
            xg, Pg, mg, dg = _two_rounds(
                step, tshd.make_sharded_map(map_cfg, group, DT), init, ins1,
                ins2, dev)
        gated = dict(
            x={f: v.cpu().numpy() for f, v in zip(xg._fields, xg)},
            equal=dict(x=all(torch.equal(a, b) for a, b in zip(x, xg)),
                       P=torch.equal(P, Pg),
                       map=torch.equal(m.packed, mg.packed),
                       diag=all(int(d[k]) == int(dg[k]) for k in d)),
            ifs=len(flags), skipped=flags.count(False),
            iters=int(dg["iters"]), same_on_every_rank=same_on_every_rank(
                group, flags))
        out[name] = dict(seen, x={f: v.cpu().numpy() for f, v in zip(x._fields, x)},
                         P=P.cpu().numpy(), map_size=int(d["map_size"]),
                         n_eff=int(d["n_eff"]), gated=gated)
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


def feed(pipe, data, lo: int = 0, hi: int = None, empty_scans=()) -> None:
    """tests/test_distributed.py's feed: scans ``lo`` to ``hi`` (default
    every scan), each with the IMU samples up to its end not pushed with an
    earlier scan; the scans in ``empty_scans`` arrive with no point."""
    hi = len(data.scans) if hi is None else hi
    imu_i = 0 if lo == 0 else int(np.searchsorted(
        data.imu_t, data.scan_stamps[lo - 1] + 0.1 + 1e-9, side="right"))
    for k in range(lo, hi):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        if k in empty_scans:
            pipe.push_lidar(stamp, np.zeros((0, 3), np.float32), np.zeros(0))
        else:
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


# tests/test_torch_sync_free.py's sparse outdoor run: every arm of the wide
# fallback (scan 4 arrives empty: none unsaturated)
SPARSE = dict(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.5,
              filter_size_map=0.5, n_points_max=2560, n_ds_max=1024,
              n_imu_max=32, map_h_log2=11, det_range=100.0,
              cube_side_length=600.0, knn_wide_fallback=True,
              map_cell_multiplier=5, knn_wide_max_queries=300)
SPARSE_EMPTY_SCANS = (4,)


def sparse_outdoor(seed: int = 0):
    """tests/test_sparse_regime.py's outdoor geometry (far walls, sparse
    returns), as tests/test_torch_pipeline.py cuts it; ``seed`` draws the
    range noise."""
    world = tsim.World(
        room_lo=np.array([-40.0, -20.0, 0.0]),
        room_hi=np.array([50.0, 70.0, 12.0]),
        pillars=(
            (np.array([-10.0, 8.0, 0.0]), np.array([-7.0, 11.0, 12.0])),
            (np.array([12.0, 25.0, 0.0]), np.array([15.5, 28.5, 12.0])),
        ),
    )
    return tsim.generate(
        tsim.SimConfig(duration=0.8, n_rings=16, n_azimuth=160,
                       elev_min=-22.0, elev_max=8.0, max_range=100.0,
                       range_noise=0.01, seed=seed),
        traj=tsim.Trajectory(radius=12.0, omega=0.4), world=world)


class RecordingGroup:
    """A ``ShardGroup`` that logs each collective it runs as (name, shape,
    dtype), and is the group otherwise."""

    def __init__(self, group: ShardGroup):
        self.group = group
        self.log = []

    def __getattr__(self, name):
        return getattr(self.group, name)

    def all_gather(self, t):
        self.log.append(("all_gather", tuple(t.shape), str(t.dtype)))
        return self.group.all_gather(t)

    def all_reduce_sum(self, t):
        self.log.append(("all_reduce_sum", tuple(t.shape), str(t.dtype)))
        return self.group.all_reduce_sum(t)


def collectives_per_step(group: ShardGroup) -> dict:
    """The capture's precondition: the sparse outdoor run, with other data
    on each rank (the range noise of seed ``rank``) and two pad buckets,
    through ``Pipeline(group=RecordingGroup(group))``.  Returns per step
    its feed length and the collectives it ran, the wide fallback's arm
    (0: none unsaturated, 1: at most the budget, 2: more) and the update's
    iterations."""
    cfg = tcfg.Config(**dict(SPARSE, pad_buckets=(1024, 2560)))
    rec = RecordingGroup(group)
    pipe = tpipe.Pipeline(cfg, group=rec)
    steps, arms = [], []
    step = pipe._packed_step

    def logged(buf):
        start = len(rec.log)
        out = step(buf)
        steps.append((buf.shape[0], rec.log[start:]))
        return out

    fallback = tpipe.wide_fallback

    def recording(base, queries, mask, rcov2, K_w):
        narrow = []

        def base_kept(q, wide=False):
            out = base(q, wide)
            if not wide:
                narrow.append(out)
            return out

        out = fallback(base_kept, queries, mask, rcov2, K_w)
        _nb, sq, found = narrow[0]
        n = int(torch.sum((~found[:, -1] | (sq[:, -1] > rcov2)) & mask))
        arms.append(0 if n == 0 else 1 if n <= K_w else 2)
        return out

    pipe._packed_step = logged
    tpipe.wide_fallback = recording
    try:
        feed(pipe, sparse_outdoor(seed=group.rank),
             empty_scans=SPARSE_EMPTY_SCANS)
    finally:
        tpipe.wide_fallback = fallback
    return dict(steps=steps, arms=arms,
                iterations=[int(d.iterations) for d in pipe.diags])


def gathered_in_rank_order(group: ShardGroup) -> bool:
    """``ShardGroup.all_gather`` returns every rank's tensor in rank order,
    as (world, *shape), for a merge's float blocks and an int32 drop
    counter: each rank rebuilds its peers' tensors from their seeds."""
    def blocks(rank):
        g = torch.Generator().manual_seed(rank)
        return [torch.randn((64, 5, 3), generator=g, dtype=DT),
                torch.arange(3, dtype=torch.int32) + rank]

    mine = [t.to(group.device) for t in blocks(group.rank)]
    want = [torch.stack(ts) for ts in
            zip(*(blocks(r) for r in range(group.world)))]
    return all(torch.equal(group.all_gather(t).cpu(), w)
               for t, w in zip(mine, want))


def capture_shape_check(group: ShardGroup) -> dict:
    """``StepGraphs``' check before a capture, on the group's device: the
    ranks about to capture the same feed shape pass, other shapes raise
    (on every rank).  Returns {"same": error or None, "other": ...}."""
    graphs = StepGraphs(group.device, group, gates=False)  # gloo ranks
    out = {}
    for case, n in (("same", 1000), ("other", 1000 + group.rank)):
        try:
            graphs._same_shape_on_every_rank(n)
            out[case] = None
        except RuntimeError as e:
            out[case] = str(e)
    return out


def distributed_run(group: ShardGroup, outdir: str, jax_ckpt: str) -> dict:
    """Every rank: the stream through ``Pipeline(group=...)``, a checkpoint
    to its own path and a resume, one more scan on both; then the JAX
    package's two-device checkpoint (written by the test while the ranks
    run) resumed and the same scan, and the stage times against the global
    map; the refusals; the collectives each step runs
    (``collectives_per_step``); the all-gather's result."""
    data = tsim.generate(tsim.SimConfig(**stream_sim_cfg()))
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **stream_cfg())
    pipe = tpipe.Pipeline(cfg, group=group)
    default_eager = pipe.graphs is None
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
    stage_times = pipe3.measure_stage_times()  # a collective

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
    refuses("graphs_gloo", lambda: tpipe.Pipeline(cfg, group=group,
                                                  graphs=True))
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
        numpy_state_same_map=numpy_state_same_map, refused=refused,
        default_eager=default_eager, stage_times=stage_times,
        collectives=collectives_per_step(group),
        capture_shape_check=capture_shape_check(group),
        gathered_in_rank_order=gathered_in_rank_order(group))


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


def state_arrays(pipe) -> dict:
    """A port pipeline's state in ``convert.KEYS``' layout (the JAX
    pipeline's arrays; a sharded pipeline's map is its own table, the
    global layout at one rank), as numpy."""
    arrays = {f: v.cpu().numpy() for f, v in zip(pipe.x._fields, pipe.x)}
    arrays.update(
        P=pipe.P.cpu().numpy(), map_packed=pipe.map.packed.cpu().numpy(),
        map_dropped=pipe.map.dropped.cpu().numpy(),
        angvel_last=pipe.imu_carry.angvel_last.cpu().numpy(),
        acc_s_last=pipe.imu_carry.acc_s_last.cpu().numpy(),
        lm_lo=pipe.lm_state[0].cpu().numpy(),
        lm_hi=pipe.lm_state[1].cpu().numpy(),
        lm_init=pipe.lm_state[2].cpu().numpy(), acc_scale=pipe.acc_scale,
        first_lidar_time=pipe.first_lidar_time,
        last_lidar_end_time=pipe.last_lidar_end_time,
        map_built=pipe.map_built, imu_need_init=pipe.imu_need_init)
    return arrays


def take_over(target, src, how: str, path) -> None:
    """``src``'s state at its last scan into ``target``, a pipeline that has
    run (and captured): by a checkpoint through ``path`` (a collective on a
    sharded pipeline) or by ``convert``'s handover; then the sync buffer
    and the trajectory, as a resumed run holds them."""
    if how == "checkpoint":
        tckpt.save_pipeline(path, src)
        tckpt.load_pipeline(path, target)
    else:
        tconvert.load_numpy_state(target, state_arrays(src))
        for f in ("mean_scantime", "scan_num", "last_imu"):
            setattr(target.sync, f, getattr(src.sync, f))
    for f in ("lidar_buf", "imu_t", "imu_acc", "imu_gyr",
              "last_timestamp_lidar", "last_timestamp_imu"):
        v = getattr(src.sync, f)
        setattr(target.sync, f, list(v) if isinstance(v, list) else v)
    target.trajectory = list(src.trajectory)


CAPTURED_WARM, HANDOVER_AT = 6, 9  # scans


def captured_rank(group: ShardGroup, outdir: str) -> dict:
    """On a card, one NCCL rank, the avia preset on 22 sim scans: the
    sharded pipeline captured (its default, gated), the scans after the first
    ``CAPTURED_WARM`` under ``set_sync_debug_mode("error")``; the same
    scans eager (``graphs=False``) and through the unsharded pipeline
    (captured); and two captured sharded pipelines that have run 4 scans
    take the state of a run at scan ``HANDOVER_AT``, by a checkpoint and by
    ``convert``'s handover, and run the rest.  Returns the positions, the
    kNN launches of the captured and eager runs, and the graphs' stats."""
    from fast_lio_tpu_torch.kernels import counts, knn

    cfg = tcfg.PRESETS["avia"]
    data = tsim.generate(tsim.SimConfig(duration=2.2, n_rings=32,
                                        n_azimuth=400))

    def positions(pipe):
        return np.stack([p for _, p, _ in pipe.get_trajectory()])

    def run(pipe, warm=len(data.scans)):
        counts.settle()  # a gated graph's launches, counted as run
        for r in knn.launches:
            knn.launches[r] = 0
        feed(pipe, data, 0, warm)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            feed(pipe, data, warm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.settle()
        return dict(knn.launches)

    out = {"transport": group.transport, "device": str(group.device)}
    captured = tpipe.Pipeline(cfg, group=group)
    out["captured_launches"] = run(captured, CAPTURED_WARM)
    out["captured"] = positions(captured)
    out["graphs"] = captured.graphs.stats()
    out["pad_buckets"] = captured.pad_buckets
    eager = tpipe.Pipeline(cfg, group=group, graphs=False)
    out["eager_launches"] = run(eager)
    out["eager"], out["eager_graphs"] = positions(eager), eager.graphs
    unsharded = tpipe.Pipeline(cfg, device=group.device)
    run(unsharded)
    out["unsharded"] = positions(unsharded)

    src = tpipe.Pipeline(cfg, group=group)
    feed(src, data, 0, HANDOVER_AT)
    for how in ("checkpoint", "state_handover"):
        target = tpipe.Pipeline(cfg, group=group)
        feed(target, data, 0, 4)
        had_graphs = bool(target.graphs.stats())
        take_over(target, src, how, Path(outdir) / "captured_rank.npz")
        feed(target, data, HANDOVER_AT)
        out[how] = dict(positions=positions(target), had_graphs=had_graphs)
    return out


# two_bucket_rank: scans fed to the large bucket first (its capture and
# replays), then every other scan cut to half its points (the small bucket,
# captured after those replays); the scans from TWO_BUCKET_STEADY on run
# under set_sync_debug_mode("error")
TWO_BUCKET_FIRST, TWO_BUCKET_STEADY = 6, 10


def two_bucket_rank(group: ShardGroup) -> dict:
    """On a card, every NCCL rank: a small float32 avia run with two pad
    buckets, the small one captured after replays of the large one, where
    the group drains the replays before its eager all-gather and warm-up
    (``ShardGroup.launching``); the last scans under
    ``set_sync_debug_mode("error")``; then ``health_check``, an eager
    collective after replays.  Returns the positions, the graphs' stats,
    the group's drains and graphs after each of the first scans, the
    drains after the steady scans and after the health check, and on
    rank 0 the same scans through the unsharded captured pipeline."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
                      filter_size_map=0.3, n_points_max=2048, n_ds_max=1024,
                      n_imu_max=32, map_h_log2=12, det_range=40.0,
                      cube_side_length=300.0, pad_buckets=(1024, 2048))
    data = tsim.generate(tsim.SimConfig(duration=2.0, n_rings=8,
                                        n_azimuth=200, range_noise=0.01))
    cut = [k >= TWO_BUCKET_FIRST and k % 2 == 1
           for k in range(len(data.scans))]
    data = dataclasses.replace(
        data, scans=[sc[::2] if c else sc for sc, c in zip(data.scans, cut)],
        scan_pt_times=[t[::2] if c else t
                       for t, c in zip(data.scan_pt_times, cut)])

    def positions(pipe):
        return np.stack([p for _, p, _ in pipe.get_trajectory()])

    pipe = tpipe.Pipeline(cfg, group=group)
    drains, n_graphs = [], []
    for k in range(TWO_BUCKET_STEADY):
        feed(pipe, data, k, k + 1)
        drains.append(group.in_flight.drains)
        n_graphs.append(len(pipe.graphs.stats()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feed(pipe, data, TWO_BUCKET_STEADY)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steady_drains = group.in_flight.drains
    health = pipe.health_check()
    out = dict(rank=group.rank, positions=positions(pipe),
               graphs=pipe.graphs.stats(), pad_buckets=pipe.pad_buckets,
               pads=[tpipe.pad_for(pipe.pad_buckets, len(sc)) for sc in data.scans],
               drains=drains, n_graphs=n_graphs, steady_drains=steady_drains,
               health_drains=group.in_flight.drains, health=health)
    if group.rank == 0:
        single = tpipe.Pipeline(cfg, device=group.device)
        feed(single, data)
        out["unsharded"] = positions(single)
    return out


def fails_on_rank_one(group: ShardGroup) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if group.rank == 1:
        raise ValueError("rank one gives up")
    group.all_reduce_sum(torch.ones(1))


# ---------------------------------------------------------------------------
# tests/test_torch_multicard.py: tools/multicard's phases on CPU ranks
# ---------------------------------------------------------------------------


def dryrun_step_f64(group: ShardGroup) -> dict:
    """``sharding.dryrun_rank``'s two chained sharded steps in float64 on
    the dry run's inputs: the state, covariance, global map and figures
    after the second, and the global map after the first (whose update
    finds no point in the empty map: it only inserts)."""
    cfg = tshd.dryrun_cfg()
    map_cfg = thm.make_config(voxel_size=cfg.filter_size_map,
                              h_log2=cfg.map_h_log2,
                              bucket_slots=cfg.map_bucket_slots)
    args = list(tshd.example_inputs(cfg, map_cfg, DT, group.device))
    args[2] = tshd.make_sharded_map(map_cfg, group, DT)
    maps = []

    def step(*a):
        out = tshd.sharded_lio_step(cfg, map_cfg, group, *a)
        maps.append(tshd.gather_global_map(out[2], group))
        return out

    out = tshd._chain(step, args)
    return dict(x={f: v.cpu().numpy() for f, v in zip(out[0]._fields, out[0])},
                P=out[1].cpu().numpy(),
                packed=[m.packed.cpu().numpy() for m in maps],
                dropped=[m.dropped.cpu().numpy() for m in maps],
                map_size=int(out[6]["map_size"]), n_eff=int(out[6]["n_eff"]))


def multicard_ranks(group: ShardGroup, outdir: str) -> dict:
    """Every rank: ``tools/multicard``'s first launch (``rank_phases``) and
    its resume (``resume_rank``, here in the same processes) at the CPU
    rehearsal's size; the dry run's step in float64
    (``dryrun_step_f64``); and ``collectives_per_step``."""
    from fast_lio_tpu_torch.tools import multicard as mc

    scale = mc.tiny_scale()
    return dict(phases=mc.rank_phases(group, scale, outdir),
                resumed=mc.resume_rank(group, scale, outdir),
                dryrun_f64=dryrun_step_f64(group),
                collectives=collectives_per_step(group))

