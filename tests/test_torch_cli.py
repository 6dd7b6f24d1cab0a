"""The port's command-line runner, ``python -m fast_lio_tpu_torch.cli``, on
the CPU: the simulated run against the JAX package's runner with the same
arguments, a bag replay with every output and a resume from its checkpoint,
fleet mode over two bags, and the device rule (no card, no ``--platform
cpu``: a non-zero exit, never a silent CPU run).

Tolerances: the port's f32 pipeline agrees with the JAX package's to 5 mm
per scan (ROADMAP.md section C); a resumed run of the port is the same code
on the same state and data, so on the CPU it equals the uninterrupted
single-stream run to the trajectory file's 6 decimals; a batched run (the
same step under vmap, whose batched matrix products round differently) is
within tests/test_torch_batch.py's BATCH_VS_SINGLE_M of it.
"""
import json

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import cli
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.utils import checkpoint as ckpt
from test_torch_batch import BATCH_VS_SINGLE_M
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# a small scan stream at the avia preset's full widths: decimation off and
# a short blind zone, as tests/test_batch.py's fleet test replays
BAG_FLAGS = ["--preset", "avia", "--point-filter-num", "1", "--blind", "0.3",
             "--platform", "cpu"]


def _gen(seed, duration):
    return tsim.generate(tsim.SimConfig(
        duration=duration, n_rings=8, n_azimuth=120, range_noise=0.005,
        seed=seed))


def _tum(path):
    return np.loadtxt(path, ndmin=2)


def test_sim_run_matches_jax_cli(tmp_path):
    from fast_lio_tpu import cli as jcli

    args = ["--sim", "--duration", "1.0", "--platform", "cpu"]
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    port = _tum(tmp_path / "port" / "trajectory_tum.txt")
    jax_ = _tum(tmp_path / "jax" / "trajectory_tum.txt")
    assert port.shape == jax_.shape and len(port) >= 8
    np.testing.assert_array_equal(port[:, 0], jax_[:, 0])
    np.testing.assert_allclose(port[:, 1:4], jax_[:, 1:4], rtol=0, atol=5e-3)


def test_bag_replay_outputs_and_resume(tmp_path, capsys):
    data = _gen(0, 2.0)
    bag = tmp_path / "run.bag"
    tsim.write_avia_bag(bag, data)
    full = tmp_path / "full"
    assert cli.main(BAG_FLAGS + [
        "--bag", str(bag), "--out", str(full), "--checkpoint", "--map-save",
        "--pcd-save", "--health", "--runtime-pos-log"]) == 0
    traj = _tum(full / "trajectory_tum.txt")
    assert len(traj) >= 15
    for name in ("checkpoint.npz", "map.pcd", "scans.pcd", "pos_log.txt",
                 "fast_lio_time_log.csv"):
        assert (full / name).is_file(), name
    assert len(ckpt.load_pcd(full / "map.pcd")) > 1000
    assert len(ckpt.load_pcd(full / "scans.pcd")) > 5000
    csv = np.genfromtxt(full / "fast_lio_time_log.csv", delimiter=",",
                        skip_header=2)
    assert len(csv) == len(traj)
    np.testing.assert_allclose(csv[:, 0], traj[:, 0], rtol=0, atol=1e-6)
    health = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith('{"health"')]
    assert health and not health[0]["health"]["nan"]

    # the first 10 scans, checkpointed; then the rest from a bag holding
    # only what the first run had not consumed
    first = tmp_path / "first"
    assert cli.main(BAG_FLAGS + ["--bag", str(bag), "--out", str(first),
                                 "--max-scans", "10", "--checkpoint"]) == 0
    meta = ckpt.load(first / "checkpoint.npz")[4]
    done_t = float(meta["last_lidar_end_time"])
    rest = [k for k, s in enumerate(data.scan_stamps) if s > done_t]
    bag2 = tmp_path / "rest.bag"
    tsim.write_avia_bag(bag2, data, scans=rest,
                        imu_after=float(meta["sync_last_imu"][0]))
    resumed = tmp_path / "resumed"
    assert cli.main(BAG_FLAGS + [
        "--bag", str(bag2), "--out", str(resumed),
        "--resume", str(first / "checkpoint.npz")]) == 0
    head = _tum(first / "trajectory_tum.txt")
    tail = _tum(resumed / "trajectory_tum.txt")
    assert len(head) + len(tail) == len(traj)
    np.testing.assert_array_equal(np.concatenate([head, tail]), traj)


def _fleet_bags(tmp_path):
    datas = [_gen(0, 1.5), _gen(1, 1.0)]  # stream 1 ends first
    bags = []
    for i, d in enumerate(datas):
        bags.append(str(tmp_path / f"s{i}.bag"))
        tsim.write_avia_bag(bags[-1], d)
    return datas, bags


def test_fleet_mode_matches_single_stream_replays(tmp_path):
    datas, bags = _fleet_bags(tmp_path)
    out = tmp_path / "fleet"
    assert cli.main(BAG_FLAGS + ["--bag", bags[0], "--bag", bags[1],
                                 "--out", str(out)]) == 0
    for i, d in enumerate(datas):
        fleet = _tum(out / f"stream{i}" / "trajectory_tum.txt")
        assert len(fleet) > 5
        single = tmp_path / f"single{i}"
        assert cli.main(BAG_FLAGS + ["--bag", bags[i],
                                     "--out", str(single)]) == 0
        # the batched step is the single step under vmap, whose batched
        # matrix products round differently: not bit for bit
        # (tests/test_torch_batch.py's bound)
        want = _tum(single / "trajectory_tum.txt")
        np.testing.assert_array_equal(fleet[:, 0], want[:, 0])
        np.testing.assert_allclose(fleet[:, 1:], want[:, 1:], rtol=0,
                                   atol=BATCH_VS_SINGLE_M)
        est = fleet[:, 1:4]
        gt = d.gt_pos[:len(est)]
        err = (est - (est[0] - gt[0])) - gt
        assert np.sqrt((err ** 2).sum(-1).mean()) < 0.15
    # single-stream surfaces are refused in fleet mode
    assert cli.main(BAG_FLAGS + ["--bag", bags[0], "--bag", bags[1],
                                 "--out", str(out), "--checkpoint"]) == 2


def test_without_a_card_the_runner_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    out = tmp_path / "out"
    assert cli.main(["--sim", "--duration", "0.3", "--out", str(out)]) != 0
    assert "--platform cpu" in capsys.readouterr().err
    assert not out.exists()
