"""Two port ranks run ``Pipeline(cfg, group=...)`` over gloo: the port's
counterpart of tests/test_distributed.py (two processes of the JAX package
over ``jax.distributed``), on its 12-scan f64 stream.

The ranks (``tests/torch_shard_workers.py::distributed_run``, launched by a
module fixture) run the stream, checkpoint each to its own path, resume, and
run one more scan on the original and the resumed pipeline; meanwhile this
process runs the JAX package on the same stream, single-device and on a
two-device mesh, and writes the mesh's checkpoint, which the ranks then
resume and run the same extra scan from.

Tolerances: the ranks' trajectories are bit-identical (the state is
replicated: it depends on the summed reductions only); the resume is
bit-exact (the same code on the same state).  Against the port's
single-device f64 run 1e-8: only the order of the summed reductions differs
(measured 1.4e-15).  Against the JAX package's single-device f64 run 5e-5,
not tests/test_distributed.py's 1e-5: on this stream the port's own
single-device run is 2.12e-5 from JAX's.  One point of the first scan lies
on a storage-cell boundary (y = 2.6e-20 in JAX, -8.5e-22 in the port: the
port's propagate rounds the last bit of the pose differently,
tests/test_torch_imu.py), so it lands in the neighbouring cell's bucket,
which some later searches do not cover.
The pose after resuming JAX's mesh checkpoint is within 1e-5 of JAX's own
next pose.
"""
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_shard_workers as w
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import launch
from fast_lio_tpu_torch.utils import checkpoint as tckpt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_PROC = 2


def _jax_runs(ckpt):
    """The JAX package on the stream: a two-device mesh (its checkpoint
    written to ``ckpt``, then one more scan) and a single device."""
    import jax
    from jax.sharding import Mesh

    from fast_lio_tpu.config import Config, LidarType
    from fast_lio_tpu.parallel.sharding import AXIS
    from fast_lio_tpu.pipeline import Pipeline
    from fast_lio_tpu.utils import checkpoint as jckpt

    data = tsim.generate(tsim.SimConfig(**w.stream_sim_cfg()))
    cfg = Config(lidar_type=LidarType.AVIA, **w.stream_cfg())
    mesh = Pipeline(cfg, mesh=Mesh(np.asarray(jax.devices()[:N_PROC]), (AXIS,)))
    w.feed(mesh, data)
    tmp = ckpt.with_name("writing.npz")
    jckpt.save_pipeline(tmp, mesh)
    os.replace(tmp, ckpt)  # the ranks poll for it
    w.feed_extra(mesh, data)
    single = Pipeline(cfg)
    w.feed(single, data)
    return dict(next_pos=np.asarray(mesh.x.pos),
                single=np.stack([p for _, p, _ in single.get_trajectory()]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    ckpt = out / "jax_mesh2.npz"
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, w.distributed_run, N_PROC,
                          args=(str(out), str(ckpt)), backend="gloo",
                          device="cpu", store_dir=out, timeout_s=900.0)
        try:
            jax = _jax_runs(ckpt)
        finally:
            if not ckpt.exists():  # stop the ranks waiting for it
                ckpt.write_bytes(b"")
        yield SimpleNamespace(ranks=ranks.result(), jax=jax, dir=out)


def test_ranks_hold_identical_trajectories(runs):
    r0, r1 = runs.ranks
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["transport"] == "gloo" and not r0["nan"]
    assert len(r0["traj"]) >= w.N_SCANS - 3
    np.testing.assert_array_equal(r0["traj"], r1["traj"])
    assert r0["stamps"] == r1["stamps"] and r0["map_size"] == r1["map_size"]


def test_ranks_match_the_single_device_runs(runs):
    traj, single = runs.ranks[0]["traj"], runs.ranks[0]["single_traj"]
    jax_single = runs.jax["single"]
    assert traj.shape == single.shape == jax_single.shape
    np.testing.assert_allclose(traj, single, rtol=0, atol=1e-8)
    np.testing.assert_allclose(traj, jax_single, rtol=0, atol=5e-5)


def test_checkpoint_round_trip_resumes_bit_exactly(runs):
    for r in runs.ranks:
        assert r["ckpt_map_size_ok"] and r["resume_exact"]


def test_both_ranks_write_the_same_global_checkpoint(runs):
    z0 = np.load(runs.dir / "dist_ckpt_0.npz")
    z1 = np.load(runs.dir / "dist_ckpt_1.npz")
    assert set(z0.files) == set(z1.files)
    for k in z0.files:
        np.testing.assert_array_equal(z0[k], z1[k], err_msg=k)
    # the JAX mesh's layout: the ranks' tables in rank order, one counter each
    jz = np.load(runs.dir / "jax_mesh2.npz")
    assert set(jz.files) == set(z0.files)
    assert z0["map_dropped"].shape == jz["map_dropped"].shape == (N_PROC,)
    assert z0["map_packed"].shape == jz["map_packed"].shape


def test_jax_mesh_checkpoint_resumes_on_two_ranks(runs):
    r0, r1 = runs.ranks
    np.testing.assert_array_equal(r0["next_pos_from_jax"], r1["next_pos_from_jax"])
    np.testing.assert_allclose(r0["next_pos_from_jax"], runs.jax["next_pos"],
                               rtol=0, atol=1e-5)
    # convert.load_numpy_state takes the same layout to the same table
    assert r0["numpy_state_same_map"] and r1["numpy_state_same_map"]


def test_sharded_pipeline_refusals(runs):
    refused = runs.ranks[0]["refused"]
    assert refused["rescore_research"].startswith("NotImplementedError")
    assert refused["device"].startswith("ValueError")
    assert refused["stage_timing"].startswith("NotImplementedError")
    assert refused["single_map_checkpoint"].startswith("ValueError")
    assert "not sharded 2 ways" in refused["single_map_checkpoint"]
    assert refused == runs.ranks[1]["refused"]


def test_single_pipeline_refuses_a_sharded_checkpoint():
    """The layouts are told apart by the drop counters: one per rank."""
    m = thm.make_map(thm.make_config(voxel_size=0.5, h_log2=5))
    pipe = SimpleNamespace(group=None, map=m)
    with pytest.raises(ValueError, match="sharded 2 ways"):
        tckpt.local_map(pipe, m.packed, torch.zeros(2, dtype=torch.int32))
    got = tckpt.local_map(pipe, m.packed.numpy(), np.zeros((), np.int32))
    assert torch.equal(got.packed, m.packed)
    with pytest.raises(ValueError, match="map_h_log2"):
        tckpt.local_map(pipe, m.packed[:16], np.zeros((), np.int32))
