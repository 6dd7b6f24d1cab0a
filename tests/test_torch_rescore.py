"""The candidate-rescoring re-search mode (``Config.rescore_research``)
against the JAX package: the candidate block of ``knn_search(...,
return_candidates=True)``, ``rescore_candidates``, a pipeline run, and the
two refused combinations.

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
from fast_lio_tpu_torch.map import hash_map as thm
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
