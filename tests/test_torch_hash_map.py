"""The port's voxel-hash map against the JAX package.

Everything here is exact: the hash is integer arithmetic, and the insert
moves f32 coordinates without arithmetic on them, so after the same inserts
the packed map must be bit-identical to JAX's (that is what lets a run
started in JAX continue in the port).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.map import hash_map as jhm
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

_j_insert = jax.jit(jhm.insert, static_argnums=1)  # op-by-op is slow on CPU


def _cells(rng):
    c = rng.integers(-2**20, 2**20, size=(2000, 3))
    extremes = np.array([[0, 0, 0], [-1, -1, -1], [2**31 - 1, -2**31, 5],
                         [-2**31, 2**31 - 1, -7], [123456, -654321, 0],
                         [-3, 4, -5]])
    return np.concatenate([c, extremes]).astype(np.int32)


def test_cell_hash_and_bucket_bit_identical():
    cells = _cells(np.random.default_rng(51))
    jh = np.asarray(jhm.cell_hash(jnp.asarray(cells)))
    th = thm.cell_hash(torch.tensor(cells)).numpy()
    np.testing.assert_array_equal(th, jh.astype(np.int64))
    for h_log2 in (4, 10, 15):
        jb = np.asarray(jhm._bucket_of(jnp.asarray(cells), h_log2))
        tb = thm._bucket_of(torch.tensor(cells), h_log2).numpy()
        np.testing.assert_array_equal(tb, jb)
        assert tb.min() >= 0 and tb.max() < 2**h_log2


def test_search_pieces_match_jax():
    rng = np.random.default_rng(52)
    cfg_t = thm.make_config(0.5, h_log2=6, cell_multiplier=4)
    cfg_j = jhm.make_config(0.5, h_log2=6, cell_multiplier=4)
    assert tuple(cfg_t) == tuple(cfg_j)
    q = rng.uniform(-30, 30, (256, 3)).astype(np.float32)
    for wide in (False, True):
        jb, jc, jr = jhm.region_cells(jnp.asarray(q), cfg_j, wide)
        tb, tc, tr = thm.region_cells(torch.tensor(q), cfg_t, wide)
        assert jr == tr
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        # h_log2=6: 64 buckets, so duplicates within a region are common
        buckets = jhm._bucket_of(jc, cfg_j.h_log2)
        jd, jdup = jhm.dedup_buckets(buckets, 63)
        td, tdup = thm.dedup_buckets(torch.tensor(np.asarray(buckets)), 63)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tdup.numpy(), np.asarray(jdup))
        assert np.asarray(jdup).any()
        jlo, jhi = jhm.region_bounds(jb, cfg_j, 3 if wide else 2)
        tlo, thi = thm.region_bounds(tb, cfg_t, 3 if wide else 2)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    # smallest_k: exact values and lowest-index tie breaks
    d2 = rng.integers(0, 6, (64, 40)).astype(np.float32)  # many ties
    jv, ji = jhm.smallest_k(jnp.asarray(d2), 5)
    tv, ti = thm.smallest_k(torch.tensor(d2), 5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _world_scans(n_scans):
    data = simlib.generate(simlib.SimConfig(duration=0.1 * (n_scans + 1),
                                            n_rings=8, n_azimuth=200))
    return [(s @ data.gt_rot[k].T + data.gt_pos[k]).astype(np.float32)
            for k, s in enumerate(data.scans[:n_scans])]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_packed_bit_identical_after_scans_of_inserts(dtype):
    """Several scans of inserts, each gated by insert_decisions on the
    current map's 5-NN (as the pipeline does), on a map small enough that
    buckets overflow and drop points."""
    cfg = thm.MapConfig(h_log2=7, bucket_slots=16, cell_size=2.0, voxel_size=0.5)
    jcfg = jhm.MapConfig(*cfg)
    jm = jhm.make_map(jcfg, jnp.dtype(dtype))
    tm = thm.make_map(cfg, getattr(torch, dtype))
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    rng = np.random.default_rng(53)
    for k, pts in enumerate(_world_scans(4)):
        pts = (pts + rng.normal(0, 0.02, pts.shape)).astype(dtype)
        mask = rng.uniform(size=len(pts)) < 0.95
        jq, tq = jnp.asarray(pts), torch.tensor(pts)
        jn, _, jf = jhm.knn_search(jm, jcfg, jq)
        tn, _, tf = thm.knn_search(tm, cfg, tq)
        inited = k >= 1
        ja, jd = jhm.insert_decisions(jq, jnp.asarray(mask), jn, jf,
                                      jnp.asarray(inited), cfg.voxel_size)
        ta, td = thm.insert_decisions(tq, torch.tensor(mask), tn, tf,
                                      torch.tensor(inited), cfg.voxel_size)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        jm = _j_insert(jm, jcfg, jq, ja, jd)
        tm = thm.insert(tm, cfg, tq, ta, td)
        np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
        assert int(tm.dropped) == int(jm.dropped)
    assert int(tm.dropped) > 0  # overflow was exercised
    assert int(thm.map_size(tm)) == int(jhm.map_size(jm))
    np.testing.assert_array_equal(thm.flatten(tm), jhm.flatten(jm))
    for a, b in zip(thm.channels(tm), jhm.channels(jm, jcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_points_matches_jax(dtype):
    cfg = thm.MapConfig(h_log2=5, bucket_slots=8, cell_size=2.0,
                        voxel_size=0.5)
    rows = np.random.default_rng(54).normal(
        size=(cfg.num_buckets, 4 * cfg.bucket_slots)).astype(dtype)
    tm = thm.from_packed(torch.tensor(rows),
                         torch.zeros((), dtype=torch.int32))
    jm = jhm.Map(packed=jnp.asarray(rows), dropped=jnp.zeros((), jnp.int32))
    got = thm.points(tm, cfg)
    assert got.shape == (cfg.num_buckets, cfg.bucket_slots, 3)
    want = jhm.points(jm, jhm.MapConfig(*cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prune_outside_matches_jax_and_gates():
    cfg = thm.MapConfig(h_log2=8, bucket_slots=16, cell_size=2.0, voxel_size=0.5)
    pts = _world_scans(1)[0]
    on = np.ones(len(pts), bool)
    tm = thm.insert(thm.make_map(cfg), cfg, torch.tensor(pts), torch.tensor(on),
                    torch.tensor(on))
    jm = _j_insert(jhm.make_map(jhm.MapConfig(*cfg)), jhm.MapConfig(*cfg),
                    jnp.asarray(pts), jnp.asarray(on), jnp.asarray(on))
    lo, hi = np.array([-3.0, -2.0, -1.0]), np.array([4.0, 2.5, 1.5])
    before = tm.packed.clone()
    same = thm.prune_outside(tm, torch.tensor(lo), torch.tensor(hi),
                             active=torch.tensor(False))
    assert torch.equal(same.packed, before)
    tm = thm.prune_outside(tm, torch.tensor(lo), torch.tensor(hi))
    jm = jhm.prune_outside(jm, jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    assert 0 < int(thm.map_size(tm)) < len(pts)


def test_insert_det_range_450_keys_match_jax():
    """900 m span in one batch (det_range-450 scale): the 15-bit-per-axis
    two-key dedup layout, with an anchor pinning the batch-min reference."""
    cfg = thm.MapConfig(h_log2=12, bucket_slots=16, cell_size=2.0, voxel_size=0.5)
    rng = np.random.default_rng(450)
    pts = np.concatenate([
        [[0.1, 0.1, 0.1], [550.1, 0.1, 0.1], [600.1, 0.1, 0.1],
         [650.1, 0.1, 0.1], [700.1, 0.1, 0.1]],
        rng.uniform(-450, 450, size=(2048, 3)),
        rng.uniform(-1, 1, size=(256, 3)),  # shared voxels: dedup winners
    ]).astype(np.float32)
    add = rng.uniform(size=len(pts)) < 0.9
    add[:5] = True
    ds = rng.uniform(size=len(pts)) < 0.8
    ds[:5] = True
    tm = thm.insert(thm.make_map(cfg), cfg, torch.tensor(pts), torch.tensor(add),
                    torch.tensor(ds))
    jm = _j_insert(jhm.make_map(jhm.MapConfig(*cfg)), jhm.MapConfig(*cfg),
                    jnp.asarray(pts), jnp.asarray(add), jnp.asarray(ds))
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    kept_x = set(thm.flatten(tm)[:, 0].tolist())
    assert {float(np.float32(v)) for v in (550.1, 600.1, 650.1, 700.1)} <= kept_x


def test_insert_refuses_h_log2_above_15():
    cfg = thm.MapConfig(h_log2=16, bucket_slots=16, cell_size=2.0, voxel_size=0.5)
    m = thm.Map(packed=torch.zeros((1, 64)), dropped=torch.zeros((), dtype=torch.int32))
    pts = torch.zeros((4, 3))
    on = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="h_log2"):
        thm.insert(m, cfg, pts, on, on)
