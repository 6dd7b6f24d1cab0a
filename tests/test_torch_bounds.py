"""The kNN bound (``kernels/bounds.py``) on tiny maps counted by hand:
distinct rows read once, bytes, operations, and which of the two bounds;
the IMU kernels' bounds counted by hand."""
import numpy as np
import pytest
import torch

from fast_lio_tpu_torch.kernels import bounds
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = thm.MapConfig(h_log2=6, bucket_slots=4, cell_size=1.0, voxel_size=0.5)


def _map(points, cfg=CFG):
    on = torch.ones(len(points), dtype=torch.bool)
    return thm.insert(thm.make_map(cfg), cfg,
                      torch.tensor(points, dtype=torch.float32), on, ~on)


def _region_buckets(q, wide):
    """The distinct buckets of one query's region, by the hash alone."""
    shift = 1.0 if wide else 0.5
    base = np.floor(np.asarray(q, np.float32) / np.float32(CFG.cell_size)
                    - np.float32(shift)).astype(np.int64)
    side = 3 if wide else 2
    cells = [base + [dx, dy, dz] for dx in range(side) for dy in range(side)
             for dz in range(side)]
    return {int(thm._bucket_of(torch.tensor(c), CFG.h_log2)) for c in cells}


@pytest.mark.parametrize("wide", [False, True])
def test_bound_counts_each_distinct_row_once(wide):
    pts = np.array([[0.2, 0.3, 0.4], [0.6, 0.1, 0.9], [3.3, 3.1, 3.2]])
    m = _map(pts)
    q = np.array([[0.7, 0.7, 0.7], [0.8, 0.6, 0.75], [3.6, 3.4, 3.5]],
                 np.float32)
    per_query = [_region_buckets(qi, wide) for qi in q]
    rows = set().union(*per_query)
    live = (thm.valid_mask(m).sum(dim=1)).tolist()
    n_live = sum(live[b] for bs in per_query for b in bs)
    n_slots = sum(len(bs) for bs in per_query) * CFG.bucket_slots
    got = bounds.knn_bound(m, CFG, torch.tensor(q), wide=wide)
    assert got.distinct_rows == len(rows) < sum(map(len, per_query))
    assert got.nbytes == len(rows) * 4 * 4 * 4 + 3 * (12 + 85)
    assert got.ops == 15 * n_live + (n_slots - n_live) and n_live > 0
    t_bytes = got.nbytes / 3.35e12 * 1e3
    t_ops = got.ops / 67e12 * 1e3
    assert got.ms == max(t_bytes, t_ops)
    assert got.by == "bytes"


def test_many_queries_on_one_full_row_are_bound_by_operations():
    """64 queries over one region whose 64-slot rows are full: each live
    slot is scored 64 times, and the operations outweigh the bytes."""
    cfg = CFG._replace(bucket_slots=64)
    rng = np.random.default_rng(81)
    m = _map(rng.uniform(0.01, 1.99, (3000, 3)), cfg)
    q = torch.tensor(rng.uniform(0.6, 0.9, (64, 3)), dtype=torch.float32)
    got = bounds.knn_bound(m, cfg, q)
    assert got.distinct_rows == len(_region_buckets(q[0].numpy(), False))
    assert got.by == "operations"
    assert got.ms == got.ops / 67e12 * 1e3


@pytest.mark.parametrize("dtype,rate", [(torch.float32, 67e12),
                                        (torch.float64, 34e12)])
def test_imu_bounds_count_the_chain_and_the_points(dtype, rate):
    """The IMU kernels' bounds counted by hand: 21 combines of 22 valid
    pairs on the 17 touched indices (11 live rows of F: 3 x 11 x 17 x 17
    fmas each), 23 steps' Fw Q Fw^T (12 x 12 entries of 12 fmas), two
    covariance steps (2 x 11 x 23 x 17), two operations a fma; an
    invalid block combines nothing.  The deskew: each point's 4 feed
    scalars read and 3 written, the knots read once."""
    fmas = 21 * 3 * 11 * 17 * 17 + 23 * 12 * 12 * 12 + 2 * 2 * 11 * 23 * 17
    b = bounds.imu_propagate_bound(22, dtype, lanes=4)
    assert (b.ops, b.by) == (4 * 2 * fmas, "operations")
    assert b.ms == pytest.approx(4 * 2 * fmas / rate * 1e3)
    assert bounds.imu_propagate_bound(0, dtype).ops == 2 * (
        12 * 12 * 12 + 2 * 2 * 11 * 23 * 17)
    size = 4 if dtype == torch.float32 else 8
    d = bounds.imu_deskew_bound(32768, 64, dtype, lanes=2)
    assert (d.nbytes, d.by) == (2 * (32768 * (4 * 4 + 3 * size)
                                     + 17 * 64 * size), "bytes")
    assert d.ms == pytest.approx(d.nbytes / 3.35e12 * 1e3)
