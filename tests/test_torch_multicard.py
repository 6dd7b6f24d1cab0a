"""``fast_lio_tpu_torch/tools/multicard.py`` on four gloo CPU ranks: the
CPU rehearsal of the sharded step across cards, and the port's four-rank
sharded step against the JAX package's over four devices.

One spawn of 4 ranks (``parallel.launch``, a module fixture running
``tests/torch_shard_workers.py::multicard_ranks``) runs the tool's phases at
its ``--device cpu`` size (the resume in the same processes, where the
tool starts fresh ones), the dry run's two chained sharded steps in f64,
and ``collectives_per_step``; this process meanwhile runs the JAX
package's ``make_sharded_step`` on 4 of the suite's 8 virtual CPU devices
on the same inputs.

Tolerances: against JAX's four-device step in f64 the state and
covariance within 1e-8 (tests/test_torch_sharding.py's 8-rank bounds),
with the map's live slots, drop counters, map size and effective points
equal: in f64 no gate flips, only the order of the summed reductions
differs.  The global map's coordinates after the first step, which only
inserts, within 1e-12, the 8-rank bound of its insert-only round; after
the second, whose points the updated pose places, within the state's
difference times (1 + the farthest coordinate): measured 2.3e-12 against
a state 7.5e-13 apart.  The f32 dry run at four
ranks is held only to the JAX package's own dry-run bounds
(``fast_lio_tpu/parallel/sharding.py:410-420``: map size and effective
points within max(8, 1%), state within 5e-3), which ``dryrun_rank``
checks.
"""
import functools
import json
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_shard_workers as w
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import check_cards, launch
from fast_lio_tpu_torch.parallel import sharding as tshd
from fast_lio_tpu_torch.tools import bench_scaling
from fast_lio_tpu_torch.tools import multicard as mc
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank spawn, running while the tests compute the JAX side: a
    future of the ranks' results."""
    out = tmp_path_factory.mktemp("multicard")
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(launch, w.multicard_ranks, WORLD, args=(str(out),),
                        backend="gloo", device="cpu", store_dir=out,
                        timeout_s=600.0)


@functools.cache
def _jax_dryrun_f64():
    """JAX's sharded step over 4 virtual devices, two chained steps on the
    dry run's inputs in f64, every input replicated over the mesh but the
    map (so the second step reuses the first one's compile)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import __graft_entry__ as ge
    from fast_lio_tpu.config import Config, LidarType
    from fast_lio_tpu.map import hash_map as jhm
    from fast_lio_tpu.parallel import sharding as jshd

    c = tshd.dryrun_cfg()
    cfg = Config(lidar_type=LidarType.AVIA, n_points_max=c.n_points_max,
                 n_ds_max=c.n_ds_max, n_imu_max=c.n_imu_max,
                 map_h_log2=c.map_h_log2, map_bucket_slots=c.map_bucket_slots,
                 det_range=c.det_range, cube_side_length=c.cube_side_length,
                 knn_wide_fallback=c.knn_wide_fallback)
    map_cfg = jhm.make_config(voxel_size=cfg.filter_size_map,
                              h_log2=cfg.map_h_log2,
                              bucket_slots=cfg.map_bucket_slots)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (jshd.AXIS,))
    rep = NamedSharding(mesh, P())
    args = [a if i == 2 else jax.tree.map(lambda v: jax.device_put(v, rep), a)
            for i, a in enumerate(ge._example_inputs(cfg, map_cfg,
                                                     jnp.float64))]
    args[2] = jshd.make_sharded_map(map_cfg, mesh, jnp.float64)
    step = jshd.make_sharded_step(cfg, map_cfg, mesh)
    out = step(*args)
    args2 = list(args)
    args2[0:4] = out[0:4]
    args2[16:19] = out[4]
    packed1 = np.asarray(out[2].packed)  # the step donates the map
    dropped1 = np.asarray(out[2].dropped)
    out = step(*args2)
    return SimpleNamespace(
        x=out[0], P=np.asarray(out[1]),
        packed=[packed1, np.asarray(out[2].packed)],
        dropped=[dropped1, np.asarray(out[2].dropped)],
        map_size=int(out[6]["map_size"]), n_eff=int(out[6]["n_eff"]))


def test_four_rank_step_matches_jax_sharded_step_in_f64(four_ranks):
    j = _jax_dryrun_f64()
    ranks = four_ranks.result()
    got = ranks[0]["dryrun_f64"]
    assert got["map_size"] == j.map_size and got["n_eff"] == j.n_eff > 0
    x_j = tst.State(*(torch.tensor(np.asarray(v)) for v in j.x))
    x_t = tst.State(**{f: torch.tensor(v) for f, v in got["x"].items()})
    dx = tst.boxminus(x_t, x_j).numpy()
    np.testing.assert_allclose(dx, 0.0, atol=1e-8)
    np.testing.assert_allclose(got["P"], j.P, rtol=0, atol=1e-8)
    B = j.packed[0].shape[1] // 4
    for step, (packed, packed_j) in enumerate(zip(got["packed"], j.packed)):
        # the same live slots and drop counters after each step
        assert packed.shape == packed_j.shape
        np.testing.assert_array_equal(packed[:, 3 * B:], packed_j[:, 3 * B:])
        np.testing.assert_array_equal(got["dropped"][step], j.dropped[step])
    # the first step only inserts (its update finds nothing in the empty
    # map): coordinates to f64 roundoff, as the 8-rank insert-only round
    np.testing.assert_allclose(got["packed"][0], j.packed[0], rtol=0,
                               atol=1e-12)
    # the second inserts points placed by the updated pose, whose bound is
    # the state's: a point at distance r moves by |dx| (1 + r)
    live = j.packed[1][:, 3 * B:] < thm.W_FREE
    coords = np.concatenate([j.packed[1][:, k * B:(k + 1) * B][live]
                             for k in range(3)])
    bound = np.abs(dx).max() * (1.0 + np.abs(coords).max() * np.sqrt(3.0))
    np.testing.assert_allclose(got["packed"][1], j.packed[1], rtol=0,
                               atol=max(bound, 1e-12))
    for r in ranks[1:]:  # replicated: every rank holds the same bits
        for f, v in got["x"].items():
            np.testing.assert_array_equal(r["dryrun_f64"]["x"][f], v)
        np.testing.assert_array_equal(r["dryrun_f64"]["packed"][1],
                                      got["packed"][1])


def test_multicard_phases_print_their_rows(four_ranks, capsys):
    """The tool's rows from the four ranks' results: each phase's checks
    pass (each row function raises otherwise) and its row has the keys a
    chip run reads."""
    ranks = four_ranks.result()
    scale = mc.tiny_scale()
    phases = [r["phases"] for r in ranks]
    dry = tshd.dryrun_row([p["dryrun"] for p in phases])
    mc.ouster64_row([p["ouster64"] for p in phases], scale,
                    "sharded_ouster64_ranks", "cpu")
    mc.f64_row([p["f64"] for p in phases], "sharded_ouster64_ranks_f64")
    mc.checkpoint_row([p["checkpoint"] for p in phases],
                      [r["resumed"] for r in ranks], "checkpoint_ranks")
    rows = {r["phase"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    assert set(rows) == {"sharded_ouster64_ranks",
                         "sharded_ouster64_ranks_f64", "checkpoint_ranks"}
    assert dry["ranks"] == WORLD and dry["ranks_agree"]
    o = rows["sharded_ouster64_ranks"]
    assert o["ranks"] == WORLD and o["transport"] == "gloo"
    assert not o["captured"] and o["graphs_by_rank"] == [None] * WORLD
    assert {"scans_per_s", "profile_per_scan_by_rank", "knn_launches_by_rank",
            "ate_raw_m", "ate_aligned_m", "health", "stage_times_s_by_rank",
            "max_pos_diff_captured_vs_eager_m", "pose_covariance_diag",
            "card"} <= o.keys()
    assert all(len(v) == WORLD for v in o["scans_per_s"].values())
    f = rows["sharded_ouster64_ranks_f64"]
    assert f["dtype"] == "torch.float64"
    assert f["max_pos_diff_vs_unsharded_m"] <= 1e-6
    c = rows["checkpoint_ranks"]
    assert c["resumed_scans"] > 0
    assert c["max_pos_diff_vs_uninterrupted_m"] <= 5e-3
    assert "not sharded 8 ways" in c["other_world_refused"]


def test_dryrun_at_four_ranks_within_jax_bounds(four_ranks):
    """The f32 dry run at four ranks: ``dryrun_rank``'s checks (the JAX
    package's dry-run bounds) passed on every rank, and they agree."""
    row = tshd.dryrun_row([r["phases"]["dryrun"] for r in four_ranks.result()])
    assert row["ranks"] == WORLD and row["transport"] == "gloo"
    assert row["ranks_agree"] and row["n_eff_single"] > 0
    for k in ("map_size", "n_eff"):
        assert abs(row[k] - row[f"{k}_single"]) <= max(
            8, row[f"{k}_single"] // 100) + row["spread"][k]
    assert row["max_dx"] < row["max_dx_bound"] == 5e-3


def test_every_step_runs_the_same_collectives_at_world_four(four_ranks):
    """The capture's precondition at four ranks (other data on each rank,
    two pad buckets, every arm of the wide fallback): the same collectives
    on every rank, and in every step of a pad bucket."""
    logs = [r["collectives"] for r in four_ranks.result()]
    assert all(c["steps"] == logs[0]["steps"] for c in logs)
    by_bucket = {}
    for n, log in logs[0]["steps"]:
        by_bucket.setdefault(n, []).append(log)
    assert len(by_bucket) == 2
    for bucket in by_bucket.values():
        assert bucket[0] and all(log == bucket[0] for log in bucket)
    for c in logs:
        assert set(c["arms"]) == {0, 1, 2}, c["arms"]


def test_nccl_ranks_take_a_card_each():
    """More NCCL ranks than cards, or several on one given card, raise;
    nothing shrinks the world.  gloo ranks may share."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card a rank"):
        check_cards(cards + 1, "nccl")
    with pytest.raises(ValueError, match="one card a rank"):
        check_cards(2, "nccl", shared=True)
    check_cards(cards + 1, "gloo", shared=True)


def test_tools_need_a_card_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    assert mc.main([]) == 1
    assert bench_scaling.main(["--trend"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_default_ranks_is_a_power_of_two_up_to_four(monkeypatch):
    got = {}
    for cards in range(0, 10):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        got[cards] = mc.default_ranks()
    assert got == {0: 1, 1: 1, 2: 2, 3: 2, 4: 4, 5: 4, 6: 4, 7: 4, 8: 4,
                   9: 4}
