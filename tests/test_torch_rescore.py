"""The candidate-rescoring re-search mode (``Config.rescore_research``)
against the JAX package: the candidate block of ``knn_search(...,
return_candidates=True)``, the custom op that computes it on the main path
(``kernels.knn.knn_search_candidates``: its plain version here, its fake
and its vmap rule; the CUDA kernel is held to it by
``tests/test_torch_knn.py``'s ``cuda`` tests), ``rescore_candidates``, a
pipeline run, the search ``make_knn_fn`` picks, the runner's A/B rule, and
the two refused combinations.

Tolerances: the candidate block and its mask are gathered, not computed, so
they are bit-equal; ``rescore_candidates`` sums three squared differences
with ``torch.sum`` where XLA reduces them in its own order, so sq agrees to
1e-6 relative, with found equal and neighbours equal where distances are
distinct; the f32 pipeline runs agree to 5 mm per scan (the f32 pipeline
tolerance of ROADMAP.md section C).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu.map import hash_map as jhm
from fast_lio_tpu.pipeline import Pipeline as JPipeline
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.tools import bench, scenarios
from fast_lio_tpu_torch.tools.microbench_knn import off_float32
from test_torch_knn import collide_scene
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = thm.MapConfig(h_log2=10, bucket_slots=16, cell_size=1.0, voxel_size=0.5)


def _port_map(points):
    on = torch.ones(len(points), dtype=torch.bool)
    return thm.insert(thm.make_map(CFG, torch.float32), CFG,
                      torch.tensor(points), on, on)


def test_candidates_and_rescore_match_jax():
    rng = np.random.default_rng(91)
    pts = rng.uniform(-4, 4, size=(2500, 3)).astype(np.float32)
    q0 = np.concatenate([rng.uniform(-3.5, 3.5, size=(96, 3)),
                         [[10.0, 10.0, 10.0], [4.4, 4.4, 4.4]]]).astype(np.float32)
    tm = _port_map(pts)
    jm = jhm.Map(packed=jnp.asarray(tm.packed.numpy()),
                 dropped=jnp.asarray(tm.dropped.numpy()))
    got = thm.knn_search(tm, CFG, torch.tensor(q0), return_candidates=True)
    want = jhm.knn_search(jm, jhm.MapConfig(*CFG), jnp.asarray(q0),
                          return_candidates=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # re-rank at positions moved a few millimetres, as between GN iterates
    q1 = (q0 + rng.normal(0, 0.003, q0.shape)).astype(np.float32)
    nb_t, sq_t, f_t = thm.rescore_candidates(got[3], got[4], torch.tensor(q1))
    nb_j, sq_j, f_j = (np.asarray(a) for a in jhm.rescore_candidates(
        want[3], want[4], jnp.asarray(q1)))
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    assert f_j.any() and not f_j.all()
    np.testing.assert_allclose(np.where(f_j, sq_t.numpy(), 0),
                               np.where(f_j, sq_j, 0), rtol=1e-6, atol=0)
    sq_f = np.where(f_j, sq_j, -1.0)
    tied = (np.abs(sq_f[:, :, None] - sq_f[:, None, :]) < 1e-9).sum(-1) > 1
    strict = f_j & ~tied
    np.testing.assert_array_equal(nb_t.numpy()[strict], nb_j[strict])


def _feed(pipe, data):
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


def test_rescore_pipeline_matches_jax(monkeypatch):
    kw = dict(filter_size_surf=0.3, filter_size_map=0.3, n_points_max=2048,
              n_ds_max=1024, n_imu_max=32, map_h_log2=12, det_range=40.0,
              cube_side_length=300.0, rescore_research=True)
    data = simlib.generate(simlib.SimConfig(duration=1.6, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))
    rescored = []
    rescore = thm.rescore_candidates

    def counting(*a, **k):
        rescored.append(1)
        return rescore(*a, **k)

    monkeypatch.setattr(thm, "rescore_candidates", counting)
    pj = JPipeline(JConfig(lidar_type=JLidarType.AVIA, **kw))
    pt = tpipe.Pipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **kw),
                        device="cpu")
    _feed(pj, data)
    _feed(pt, data)
    pos_j = np.stack([p for _, p, _ in pj.get_trajectory()])
    pos_t = np.stack([p for _, p, _ in pt.get_trajectory()])
    assert len(pos_t) == len(pos_j) >= 14
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=5e-3)
    assert len(rescored) >= len(pos_t)  # the loop re-ranked, every scan
    assert (simlib.ate_rmse(pt.get_trajectory(), data)
            <= simlib.ate_rmse(pj.get_trajectory(), data) + 1e-3)


def test_rescore_refuses_wide_fallback_and_grouped():
    cfg = dataclasses.replace(tcfg.PRESETS["avia"], map_h_log2=10,
                              rescore_research=True)
    mcfg = thm.make_config(0.5, h_log2=10)
    m = thm.make_map(mcfg)
    wide = dataclasses.replace(cfg, knn_wide_fallback=True)
    with pytest.raises(ValueError, match="wide"):
        tpipe.make_knn_fn(wide, mcfg, m)
    with pytest.raises(ValueError, match="wide"):
        tpipe.Pipeline(wide, device="cpu")
    grouped = dataclasses.replace(cfg, knn_backend="grouped")
    with pytest.raises(ValueError, match="grouped"):
        tpipe.make_knn_fn(grouped, mcfg, m)
    with pytest.raises(ValueError, match="grouped"):
        tpipe.Pipeline(grouped, device="cpu")
    # alone, rescore returns the candidate block with the search
    out = tpipe.make_knn_fn(cfg, mcfg, m)(torch.zeros((4, 3)), None)
    assert len(out) == 5 and out[3].shape == (4, 8 * 64, 3)


def _block_kinds(cfg, tm, q, cand_pts, cand_ok):
    """How many slots of the block are of each kind: in a duplicate's
    sentinel row, live outside the region's AABB, dead with coordinates
    (pruned), and candidates (live inside)."""
    B = cfg.bucket_slots
    buckets = thm._bucket_of(thm.region_cells(q, cfg)[1], cfg.h_log2)
    b_sorted, dup = thm.dedup_buckets(buckets, cfg.num_buckets - 1)
    w = tm.packed[b_sorted][..., 3 * B:].reshape(len(q), 8 * B)
    dup = dup.repeat_interleave(B, dim=-1)
    live = (w == 0) & ~dup
    return {"sentinel": int(dup.sum()),
            "outside": int((live & ~cand_ok).sum()),
            "dead_with_coords": int((~live & ~dup & (cand_pts != 0).any(-1))
                                    .sum()),
            "candidates": int(cand_ok.sum()),
            "flagged_in_sentinel_rows": int((cand_ok & dup).sum())}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_candidates_op_matches_jax_block(dtype):
    """The op on CPU tensors: its five outputs bit-equal to JAX's
    ``knn_search(return_candidates=True)``, the whole block (every slot's
    coordinates and flag) on a map with duplicate buckets, slots outside
    the AABB and pruned slots; float64 off the float32 grid."""
    cfg, tm, q = collide_scene()
    if dtype == torch.float64:
        tm, q = off_float32(tm, q, 67)
    got = tknn.knn_search_candidates(tm, cfg, q)
    want = jhm.knn_search(
        jhm.Map(packed=jnp.asarray(tm.packed.numpy()),
                dropped=jnp.asarray(tm.dropped.numpy())),
        jhm.MapConfig(*cfg), jnp.asarray(q.numpy()), return_candidates=True)
    assert [t.dtype for t in got] == [dtype, dtype, torch.bool, dtype,
                                      torch.bool]
    assert got[3].shape == (len(q), 8 * cfg.bucket_slots, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kinds = _block_kinds(cfg, tm, q, got[3], got[4])
    assert kinds["flagged_in_sentinel_rows"] == 0
    assert all(kinds[k] > 0 for k in ("sentinel", "outside",
                                      "dead_with_coords", "candidates"))


def test_candidates_op_fake_and_vmap():
    """The op's schema and fake (the five outputs' shapes and dtypes), and
    its vmap rule on the CPU: every stream's own map and queries through the
    plain version, stream by stream."""
    cfg, tm, q = collide_scene(n=24)
    args = (tm.packed, q, cfg.h_log2, cfg.bucket_slots, cfg.cell_size,
            cfg.voxel_size, 5)
    torch.library.opcheck(tknn._cand_op, args,
                          test_utils=("test_schema", "test_faketensor"))
    fake = tknn._cand_fake(*args)
    assert [tuple(t.shape) for t in fake] == [(24, 5, 3), (24, 5), (24, 5),
                                             (24, 128, 3), (24, 128)]
    maps = torch.stack([tm.packed, torch.flip(tm.packed, [0]),
                        torch.roll(tm.packed, 3, 0)])
    qs = torch.stack([q, torch.flip(q, [0]), q + 0.25])
    got = torch.func.vmap(lambda p, x: tknn.knn_search_candidates(
        thm.Map(p, None), cfg, x))(maps, qs)
    assert len(got) == 5
    for s in range(3):
        ref = thm.knn_search(thm.Map(maps[s], None), cfg, qs[s],
                             return_candidates=True)
        for a, b in zip(got, ref):
            assert torch.equal(a[s], b)
    # a map shared by the streams (in_dims None) is broadcast
    shared = torch.func.vmap(lambda x: tknn.knn_search_candidates(
        tm, cfg, x))(qs)
    for a, b in zip(shared, thm.knn_search(tm, cfg, qs[2],
                                           return_candidates=True)):
        assert torch.equal(a[2], b)


def test_make_knn_fn_takes_the_candidates_op(monkeypatch):
    """Under ``rescore_research`` the search is the op (the kernel's
    candidates variant on the card); without it, never."""
    calls = []
    op = tknn.knn_search_candidates

    def counting(*a, **k):
        calls.append(1)
        return op(*a, **k)

    monkeypatch.setattr(tknn, "knn_search_candidates", counting)
    cfg, tm, q = collide_scene(n=16)
    on = dataclasses.replace(tcfg.PRESETS["avia"], rescore_research=True)
    out = tpipe.make_knn_fn(on, cfg, tm)(q, None)
    assert calls == [1]
    for a, b in zip(out, thm.knn_search(tm, cfg, q, return_candidates=True)):
        assert torch.equal(a, b)
    off = dataclasses.replace(on, rescore_research=False)
    assert len(tpipe.make_knn_fn(off, cfg, tm)(q, None)) == 3
    assert calls == [1]


def test_runner_keeps_the_rescore_on_the_card(capsys):
    """``tools/bench.configure`` with ``FAST_LIO_RESCORE=1``: the rescore
    on bench.py's avia, whatever the device (the card's search is the
    candidates kernel, named by ``knn_backend``), and refused with bench.py's
    message on every scenario with the wide fallback."""
    env = {"FAST_LIO_RESCORE": "1"}
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in scenarios.NAMES:
        cfg = scenarios.config(name)
        got = bench.configure(name, cfg, env)
        err = capsys.readouterr().err
        if cfg.knn_wide_fallback:
            assert got == cfg and err.startswith(
                f"FAST_LIO_RESCORE=1 ignored: scenario {name!r} uses "
                "knn_wide_fallback")
            assert bench.knn_backend(got, cuda) == "cuda_per_query"
        else:
            assert got.rescore_research and err == ""
            assert bench.knn_backend(got, cuda) == "cuda_per_query_candidates"
            assert bench.knn_backend(got, cpu) == "plain_candidates"
    assert [n for n in scenarios.NAMES
            if not scenarios.config(n).knn_wide_fallback] == ["avia"]
