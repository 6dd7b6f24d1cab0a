"""The map sharded spatially across ranks.

Port of ``fast_lio_tpu/parallel/sharding.py``.  Each rank owns the storage
cells whose hash bits above the bucket index name it, and holds them in a
table of its own (the single map's structure with 1/n of the buckets); the
filter is replicated:

* kNN: every rank searches its table for all queries (the queries are
  replicated), the per-rank top-k are all-gathered and re-top-k'd: exact,
  since the union of the per-rank k-NN holds the global k-NN.
* Gauss-Newton: each rank builds the H rows of its slice of the points
  (``arange(N) % n == rank``); H^T H and H^T h, the update's only
  reductions over the points, are summed across ranks.
* insert / prune: each rank applies the replicated insert decisions to the
  points it owns; the prune runs on every table.

The JAX package runs this under ``shard_map`` in one jitted program; here
every rank runs ``sharded_lio_step`` in its own process, with the
collectives of its ``ShardGroup``, and a ``Pipeline`` on NCCL ranks captures
it in one CUDA graph per pad bucket on every rank (``step_graph.py``; gloo
ranks run it eagerly).  The step reads nothing on the host, and every
``control_flow.gate`` in it (the filter's passes, the re-search with its
merge, the wide fallback, the prune) picks from replicated values: the
merged kNN results, the summed reductions (``valid`` among them:
``filter/ekf.py``) and the state they give.  So in a captured step, where
each gate is a CUDA-graph IF node, every rank runs or skips each body, with
the collectives in it, with its peers, as JAX's ``shard_map`` runs its
``lax.while_loop`` and ``lax.cond``s; eager (gloo) every rank runs every
arm masked.  Each collective has a fixed shape: two all-gathers per merge,
one all-reduce per filter pass and one for the map size.  The
per-rank search is the per-query CUDA kernel (``kernels.knn.knn_search``, its
plain version on CPU tensors) whatever ``Config.knn_backend`` says, as the
JAX sharded path always runs the single-table search: ``"grouped"`` does not
apply here.

The global layout (``gather_global_map``) is the JAX package's: the ranks'
tables stacked on the bucket dim in rank order, ``(n * H_local, 4B)``, with
``dropped`` of shape ``(n,)``.  For a power-of-two n whose local tables keep
at least 16 buckets, row ``rank * H_local + bucket`` is the single map's
bucket of the same hash bits, so the global layout is the single map's.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import imu as imu_mod
from .. import state as st
from ..config import Config, LidarType
from ..filter import ekf, process
from ..kernels import knn as knn_kernel
from ..map import hash_map as hm
from ..math import so3
from ..ops import measurement as meas
from ..ops.voxel_grid import voxel_downsample
from . import ShardGroup, check_world, launch

# Intercept attribution at one rank (tools/bench_scaling.py --ablate): each
# skips one sharded-only cost and stays exact at n = 1 only; at n > 1 the
# results would be per-rank, not global.  Read when the step runs, so a
# captured step keeps the flags it was recorded with: a change of them needs
# a fresh Pipeline (bench_scaling builds one per pass).
ABLATE_NO_MERGE = False  # skip the all-gather + re-top-k of the kNN
ABLATE_NO_PSUM = False  # skip the sums of the GN reductions and map size


def local_map_cfg(cfg_global: hm.MapConfig, n_ranks: int) -> hm.MapConfig:
    """A rank's table: the capacity split n ways (n a power of two, so the
    owner can take the hash bits above the bucket index)."""
    check_world(n_ranks)
    shift = n_ranks.bit_length() - 1
    return cfg_global._replace(h_log2=max(cfg_global.h_log2 - shift, 4))


def make_sharded_map(cfg_global: hm.MapConfig, group: ShardGroup,
                     dtype=torch.float32) -> hm.Map:
    """This rank's empty table, with its own 1-element drop counter."""
    m = hm.make_map(local_map_cfg(cfg_global, group.world), dtype, group.device)
    return m._replace(dropped=m.dropped.reshape(1))


def gather_global_map(m_local: hm.Map, group: ShardGroup) -> hm.Map:
    """The global layout, on every rank: packed (n * H_local, 4B) in rank
    order and dropped (n,).  A collective."""
    packed = group.all_gather(m_local.packed)
    return hm.Map(packed=packed.reshape(-1, packed.shape[-1]),
                  dropped=group.all_gather(m_local.dropped.reshape(1)).reshape(-1))


def split_global_map(packed, dropped, rank: int, world: int) -> hm.Map:
    """Rank ``rank``'s table of a global layout (tensors or arrays):
    ``packed`` (n * H_local, 4B), ``dropped`` (n,).  Raises ValueError on a
    layout of another world size."""
    packed, dropped = torch.as_tensor(packed), torch.as_tensor(dropped)
    if tuple(dropped.shape) != (world,) or packed.shape[0] % world:
        raise ValueError(
            f"a global map of {tuple(packed.shape)} rows with drop counters "
            f"{tuple(dropped.shape)} is not sharded {world} ways")
    h = packed.shape[0] // world
    return hm.from_packed(packed[rank * h:(rank + 1) * h],
                          dropped[rank:rank + 1].to(torch.int32))


def owner_of(cell: torch.Tensor, lcfg: hm.MapConfig, n: int) -> torch.Tensor:
    """Rank owning each storage cell: the hash bits above the bucket index
    (int64; the JAX package's uint32 arithmetic, bit for bit)."""
    h = hm.cell_hash(cell) & 0xFFFFFFFF  # the uint32 view
    return (h >> lcfg.h_log2) % n


def merge_candidates(all_nbrs: torch.Tensor, all_sq: torch.Tensor, k: int):
    """Re-top-k of the ranks' candidates: all_nbrs (n, N, k, 3), all_sq
    (n, N, k) -> (nbrs (N, k, 3), sq (N, k), found (N, k)).  The candidates
    of a query are taken rank-major (rank 0's k first), the JAX package's
    order, so ties resolve as there."""
    n, N = all_sq.shape[0], all_sq.shape[1]
    nbrs = torch.movedim(all_nbrs, 0, 1).reshape(N, n * k, 3)
    sq = torch.movedim(all_sq, 0, 1).reshape(N, n * k)
    sq_m, idx = hm.smallest_k(
        torch.where(torch.isfinite(sq), sq, torch.full_like(sq, torch.inf)), k)
    return (torch.take_along_dim(nbrs, idx[..., None], dim=1), sq_m,
            torch.isfinite(sq_m))


def merge(group: ShardGroup, nbrs, sq, k):
    """One all-gather of every rank's (N, k, 3) and (N, k) blocks, then
    ``merge_candidates``: the exact global kNN, the same on every rank."""
    return merge_candidates(group.all_gather(nbrs), group.all_gather(sq), k)


def merged_knn(group: ShardGroup, m_local: hm.Map, lcfg: hm.MapConfig,
               queries: torch.Tensor, k: int, cfg: Config, mask: torch.Tensor):
    """The exact global kNN over every rank's table, with the single map's
    adaptive wide-region fallback (``Config.knn_wide_fallback``):
    ``pipeline.wide_fallback`` around the merged search.  The wide search
    is gated on a count of the merged narrow results, the same on every
    rank, so all ranks enter the same collectives, with no host read."""
    from ..pipeline import wide_fallback

    def local(q, wide=False):
        return knn_kernel.knn_search(m_local, lcfg, q, k=k, wide=wide)

    if ABLATE_NO_MERGE:  # exact at n = 1 only (the union is the local set)
        if cfg.knn_wide_fallback:
            raise ValueError("ABLATE_NO_MERGE skips the wide fallback")
        return local(queries)

    def base(q, wide=False):
        nbrs, sq, _found = local(q, wide)
        return merge(group, nbrs, sq, k)

    if not cfg.knn_wide_fallback:
        return base(queries)
    return wide_fallback(base, queries, mask, (0.5 * lcfg.cell_size) ** 2,
                         cfg.knn_wide_max_queries)


def sharded_lio_step(
    cfg: Config,
    map_cfg_global: hm.MapConfig,
    group: ShardGroup,
    x: st.State,
    P_,
    m_local: hm.Map,
    imu_carry: imu_mod.ImuCarry,
    Q,
    imu_t_rel,
    imu_acc,
    imu_gyr,
    imu_mask,
    acc_scale,
    last_end_rel,
    pcl_end_rel,
    pts,
    pt_time,
    pt_mask,
    pt_intensity,
    lm_lo,
    lm_hi,
    lm_init,
    ekf_inited,
    do_update: bool = True,
):
    """``pipeline.lio_step`` on one rank: ``m_local`` is its table, all else
    replicated.  Returns what ``lio_step`` returns; ``map_size`` is the
    global count, ``n_eff`` the rank's own (from the replicated selection,
    so already global: a sum would count it n times)."""
    from ..pipeline import fov_segment

    n, my = group.world, group.rank
    lcfg = local_map_cfg(map_cfg_global, n)
    deskew = cfg.lidar_type != LidarType.MARSIM
    N = cfg.n_ds_max

    # 1-3: replicated propagate + deskew, cube slide, downsample; the prune
    # runs on every table under the device-side `moved` gate
    x, P_, pts_d, imu_carry = imu_mod.propagate_and_deskew(
        x, P_, Q, imu_t_rel, imu_acc, imu_gyr, imu_mask, acc_scale,
        last_end_rel, pcl_end_rel, imu_carry, pts, pt_time, deskew=deskew)
    pos_lid = x.pos + so3.quat_rotate(x.rot, x.offset_T_L_I)
    new_lo, new_hi, lm_init2 = fov_segment(cfg, pos_lid, lm_lo, lm_hi, lm_init)
    moved = torch.any(new_lo != lm_lo) | ~lm_init
    lm_lo, lm_hi, lm_init = new_lo, new_hi, lm_init2
    m_local = hm.prune_outside(m_local, lm_lo, lm_hi, active=moved)
    pts_ds, ds_mask, int_ds = voxel_downsample(
        pts_d, pt_mask, cfg.filter_size_surf, N, feats=pt_intensity,
        coord_bound=cfg.det_range * 1.25 + 5.0)

    # 4: update with the merged kNN, this rank's rows, summed reductions
    cache0 = meas.empty_cache(N, pts_ds.dtype, pts_ds.device)
    knn_fn = lambda q, mask: merged_knn(  # noqa: E731
        group, m_local, lcfg, q, meas.NUM_MATCH, cfg=cfg, mask=mask)
    slice_mask = (torch.arange(N, device=pts_ds.device) % n) == my

    def h_fn(x_i, converge, cache):
        h_x, h, rows, cache, valid, _pw = meas.compute_measurement(
            x_i, pts_ds, ds_mask, knn_fn, cache, converge,
            cfg.extrinsic_est_en, row_mask=slice_mask)
        return ekf.MeasOut(h_x, h, rows, valid, cache)

    if do_update:
        res = ekf.update_iterated(
            x, P_, h_fn, cache0, cfg.laser_point_cov, cfg.max_iteration,
            cfg.epsi, group=None if ABLATE_NO_PSUM else group)
        x, P_, cache, iters = res.x, res.P, res.carry, res.iterations
    else:
        cache = cache0
        iters = torch.zeros((), dtype=torch.int32, device=P_.device)
    n_eff = torch.sum(cache.selected)

    # 5: insert routed to the owning rank
    pts_world = meas.body_to_world(x, pts_ds)
    add_mask, ds_flag = hm.insert_decisions(
        pts_world, ds_mask, cache.nbrs, cache.found, ekf_inited,
        cfg.filter_size_map)
    owner = owner_of(hm._cell_of(pts_world, lcfg.cell_size), lcfg, n)
    m_local = hm.insert(m_local, lcfg, pts_world, add_mask & (owner == my),
                        ds_flag)

    size = hm.map_size(m_local)
    if not ABLATE_NO_PSUM:
        size = group.all_reduce_sum(size.reshape(1))[0]
    diag = dict(n_down=torch.sum(ds_mask), n_eff=n_eff, iters=iters,
                map_size=size)
    clouds = dict(world=pts_world, world_mask=ds_mask,
                  world_intensity=int_ds, body=pts_d, body_mask=pt_mask,
                  body_intensity=pt_intensity, effect_mask=cache.selected)
    return x, P_, m_local, imu_carry, (lm_lo, lm_hi, lm_init), clouds, diag


# ---------------------------------------------------------------------------
# dry run: two chained steps against the unsharded step
# ---------------------------------------------------------------------------


def example_inputs(cfg: Config, map_cfg: hm.MapConfig, dtype, device):
    """``lio_step``'s arguments for one scan of a box world (floor and two
    walls, so planes fit and the update runs), from seed 0; the cube is
    centred at the origin and does not slide.  The JAX package builds the
    same scene for its dry run."""
    rng = np.random.default_rng(0)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    x = st.identity_state(dtype, device)._replace(
        grav=t([0.0, 0.0, -st.S2_LENGTH]))
    M, N = cfg.n_imu_max, cfg.n_points_max
    imu_acc = np.tile([0, 0, st.S2_LENGTH], (M, 1)) + rng.normal(size=(M, 3)) * 1e-3
    imu_gyr = rng.normal(size=(M, 3)) * 1e-2
    n_per = N // 3
    u = rng.uniform(-8, 8, size=(n_per, 2))
    floor = np.column_stack([u[:, 0], u[:, 1], np.zeros(n_per)])
    wall1 = np.column_stack([np.full(n_per, 8.0), u[:, 0], 0.5 + 0.2 * u[:, 1]])
    wall2 = np.column_stack([u[:, 0], np.full(n_per, -8.0), 0.5 + 0.2 * u[:, 1]])
    pts = np.concatenate([floor, wall1, wall2])
    pts = np.concatenate([pts, np.zeros((N - len(pts), 3))])
    pt_int = rng.uniform(0, 255, size=N)
    half = 0.5 * cfg.cube_side_length
    return (
        x, torch.eye(st.DOF, dtype=dtype, device=device),
        hm.make_map(map_cfg, dtype, device), imu_mod.init_imu_carry(dtype, device),
        process.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, dtype, device),
        t(np.linspace(0, 0.1, M)), t(imu_acc), t(imu_gyr),
        torch.ones(M, dtype=torch.bool, device=device),
        t(1.0), t(0.0), t(0.1), t(pts), t(np.linspace(0, 0.1, N)),
        torch.as_tensor(np.arange(N) < 3 * n_per, device=device), t(pt_int),
        t([-half] * 3), t([half] * 3),
        torch.tensor(True, device=device), torch.tensor(True, device=device),
    )


def dryrun_cfg() -> Config:
    """The dry run's configuration: the JAX package's, wide fallback on."""
    return Config(lidar_type=LidarType.AVIA, n_points_max=1024, n_ds_max=512,
                  n_imu_max=8, map_h_log2=10, map_bucket_slots=8,
                  det_range=40.0, cube_side_length=300.0,
                  knn_wide_fallback=True)


def _chain(step, args):
    """Two steps, the second fed the first's state and cube."""
    out = step(*args)
    args2 = list(args)
    args2[0:4] = out[0:4]
    args2[16:19] = out[4]
    return step(*args2)


def dryrun_rank(group: ShardGroup) -> dict:
    """One rank of ``dryrun``: two chained sharded steps on the dry run's
    inputs, checked against two unsharded steps (every rank runs those
    itself).  f32 and reordered sums may flip a few gate decisions at voxel
    boundaries, so: map size and effective points within max(8, 1%), the
    JAX package's bound, plus how far two runs of the unsharded steps
    differ here (nothing: they sum in one order on every run); state within
    5e-3 (the bit-tight f64 proof is
    tests/test_torch_sharding.py).  Returns the figures; raises on a failed
    check."""
    from ..pipeline import lio_step

    cfg = dryrun_cfg()
    map_cfg = hm.make_config(voxel_size=cfg.filter_size_map,
                             h_log2=cfg.map_h_log2,
                             bucket_slots=cfg.map_bucket_slots)
    args = list(example_inputs(cfg, map_cfg, torch.float32, group.device))
    args[2] = make_sharded_map(map_cfg, group)
    out = _chain(lambda *a: sharded_lio_step(cfg, map_cfg, group, *a), args)
    refs = []
    update = torch.ones((), dtype=torch.bool, device=group.device)
    for _ in range(2):
        args[2] = hm.make_map(map_cfg, torch.float32, group.device)
        refs.append(_chain(lambda *a: lio_step(cfg, map_cfg, *a,
                                               do_update=update), args))
    ref = refs[0]

    size_m, size_s = int(out[6]["map_size"]), int(ref[6]["map_size"])
    neff_m, neff_s = int(out[6]["n_eff"]), int(ref[6]["n_eff"])
    dx = float(torch.abs(st.boxminus(out[0], ref[0])).max())
    if neff_s == 0:
        raise RuntimeError("dry run never exercised the update")
    spreads = {}
    for what, key, a, b in (("map size", "map_size", size_m, size_s),
                            ("effective points", "n_eff", neff_m, neff_s)):
        spread = spreads[key] = abs(int(refs[1][6][key]) - b)
        if abs(a - b) > max(8, b // 100) + spread:
            raise RuntimeError(f"{what} diverged: {a} sharded, {b} single "
                               f"(two single runs {spread} apart)")
    if not dx < 5e-3:
        raise RuntimeError(f"state diverged from single rank: |dx| = {dx}")
    return dict(rank=group.rank, world=group.world, map_size=size_m,
                map_size_single=size_s, map_size_spread=spreads["map_size"],
                n_eff=neff_m, n_eff_single=neff_s,
                n_eff_spread=spreads["n_eff"], max_dx=dx,
                transport=group.transport)


def dryrun_row(ranks: list) -> dict:
    """The dry run's JSON row from every rank's ``dryrun_rank`` figures:
    the JAX package's (map size and effective points, sharded against
    single, and the largest state difference over the ranks), rank 0's
    spread of two single runs, and whether the ranks agree on the sharded
    figures (replicated; each rank runs its own single steps)."""
    r = ranks[0]
    keys = ("map_size", "map_size_single", "n_eff", "n_eff_single")
    return {"phase": "dryrun", "ranks": r["world"],
            "transport": r["transport"], **{k: r[k] for k in keys},
            "spread": {k: r[f"{k}_spread"] for k in ("map_size", "n_eff")},
            "max_dx": max(x["max_dx"] for x in ranks), "max_dx_bound": 5e-3,
            "ranks_agree": all(x[k] == r[k] for x in ranks
                               for k in ("map_size", "n_eff"))}


def dryrun(world: int = 2, backend: str = None, device=None) -> list:
    """Launch ``world`` ranks (``parallel.launch``), run ``dryrun_rank`` on
    each, print ``dryrun_row`` as one JSON line, and return the ranks'
    figures: the counterpart of the JAX package's ``dryrun_multichip``.
    Ranks run on CUDA by default, one card each over NCCL; two ranks
    sharing one card pass ``backend="gloo"``, CPU ranks ``device="cpu"``."""
    res = launch(dryrun_rank, world, backend=backend, device=device)
    print(json.dumps(dryrun_row(res)), flush=True)
    return res
