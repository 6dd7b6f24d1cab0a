"""The port's map sharding (``fast_lio_tpu_torch/parallel``) against the JAX
package's (``fast_lio_tpu/parallel/sharding.py``), on CPU ranks over gloo.

One spawn of 8 ranks (``parallel.launch``, a module fixture started by the
first test, running ``tests/torch_shard_workers.py``) runs the four cases of
tests/test_sharding.py in f64, the dry run, and on rank 0 alone each case at
one rank; the JAX side runs in this process on its 8 virtual devices, while
the ranks run.

Tolerances: the global map after the insert-only round is the port's single
map bit for bit (the same insert, routed by the same hash bits), and holds
the JAX package's sharded map's live slots and drop counters bit for bit,
with coordinates within 1e-12 (the port's propagate and deskew chain the IMU
samples in a loop where JAX scans, so rotation and deskewed points differ
in the last bits, 1e-15 in f64: tests/test_torch_imu.py);
the merged kNN equals JAX's single-table search (found equal, sq to 1e-11,
the JAX test's bound), and its wide fallback takes the arm the case names;
after the update round map size and effective points are equal, and the
state and covariance within 1e-8 of JAX's single-device step: in f64 no gate
flips, and only the order of the summed reductions differs (gloo's ring
against one matmul).  At one rank the sharded step is bit-equal to the
port's unsharded step.  Each case runs again with the step's gates as in a
captured NCCL rank, each IF node a host branch: bit-equal to the masked
step, the same predicates on every rank (all-gathered), the state within
1e-8 of JAX's.  On cards (``cuda``): NCCL collectives inside an IF node at
one and four ranks (``multicard.if_node_rank``), and inside a WHILE node
that runs them 1, 3 and 5 times a replay (``multicard.while_node_rank``).
"""
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_shard_workers as w
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import init_distributed, launch
from fast_lio_tpu_torch.parallel import sharding as tshd
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 8
POS_TOL_M = 5e-3  # one NCCL rank against the unsharded run on a card


@functools.cache
def _jax():
    """The JAX side, imported on first use: the CUDA case runs on a card's
    host, which has no JAX (``pytest --noconftest -m cuda``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from fast_lio_tpu import imu as jimu
    from fast_lio_tpu import state as jst
    from fast_lio_tpu.config import Config, LidarType
    from fast_lio_tpu.map import hash_map as jhm
    from fast_lio_tpu.parallel import sharding as jshd
    from fast_lio_tpu.pipeline import lio_step, make_knn_fn

    return SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh, P=P, jimu=jimu,
                           jst=jst, Config=Config, LidarType=LidarType,
                           jhm=jhm, jshd=jshd, lio_step=lio_step,
                           make_knn_fn=make_knn_fn)


def _inputs():
    return (w.initial_state_np(), w.step_inputs(2048, 16, 1),
            w.step_inputs(2048, 16, 2))


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """The 8-rank spawn, running while the tests compute the JAX side: a
    future of the ranks' results."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(launch, w.sharding_cases, WORLD, args=_inputs(),
                        backend="gloo", device="cpu",
                        store_dir=tmp_path_factory.mktemp("store"),
                        timeout_s=600.0)


def _jcfg(wide, wmax):
    J = _jax()
    cfg = J.Config(lidar_type=J.LidarType.AVIA, **w.step_cfg(wide, wmax))
    return cfg, J.jhm.make_config(**w.step_map_cfg())


def _jins(ins):
    J = _jax()
    return [J.jnp.asarray(a) if np.asarray(a).dtype == bool
            else J.jnp.asarray(a, J.jnp.float64) for a in ins]


def _jstate(init):
    J = _jax()
    x = J.jst.State(**{f: J.jnp.asarray(v) for f, v in init["x"].items()})
    return (x, J.jnp.asarray(init["P"]), J.jimu.init_imu_carry(J.jnp.float64),
            J.jnp.asarray(init["Q"]))


def _jax_sharded_specs():
    J = _jax()
    rep = J.P()
    map_specs = J.jhm.Map(packed=J.P(J.jshd.AXIS), dropped=J.P(J.jshd.AXIS))
    x_spec = J.jst.State(*([rep] * 8))
    carry_spec = J.jimu.ImuCarry(rep, rep)
    in_specs = (x_spec, rep, map_specs, carry_spec, rep) + (rep,) * 15
    out_specs = (x_spec, rep, map_specs, carry_spec, (rep, rep, rep),
                 dict(world=rep, world_mask=rep, world_intensity=rep, body=rep,
                      body_mask=rep, body_intensity=rep, effect_mask=rep),
                 dict(n_down=rep, n_eff=rep, iters=rep, map_size=rep))
    return map_specs, in_specs, out_specs


@functools.cache
def _jax_round1():
    """JAX after the insert-only round: the single-device step's outputs,
    and the 8-device sharded map (the same for every case: no search
    runs)."""
    J = _jax()
    init, ins1, _ins2 = _inputs()
    cfg, map_cfg = _jcfg(False, 2048)
    x0, P0, c0, Q = _jstate(init)
    single = J.jax.jit(lambda *a: J.lio_step(cfg, map_cfg, *a, do_update=False))(
        x0, P0, J.jhm.make_map(map_cfg, J.jnp.float64), c0, Q, *_jins(ins1))
    mesh = J.Mesh(np.asarray(J.jax.devices()[:WORLD]), (J.jshd.AXIS,))
    _map_specs, in_specs, out_specs = _jax_sharded_specs()
    step = J.jax.jit(J.jax.shard_map(
        functools.partial(J.jshd.sharded_lio_step, cfg, map_cfg, WORLD,
                          do_update=False),
        mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))
    sharded = step(x0, P0, J.jshd.make_sharded_map(map_cfg, mesh,
                                                   J.jnp.float64),
                   c0, Q, *_jins(ins1))
    return (single, np.asarray(sharded[2].packed),
            np.asarray(sharded[2].dropped))


def _jax_case(name):
    """JAX's single-table kNN (with the case's fallback) on the round-1
    map, and its single-device update round."""
    J = _jax()
    init, _ins1, ins2 = _inputs()
    cfg, map_cfg = _jcfg(*w.CASES[name])
    xs, Ps, m_s, cs = _jax_round1()[0][:4]
    q = w.knn_queries(np.asarray(J.jhm.flatten(m_s)))
    mask = np.ones(len(q), bool)
    knn = J.jax.jit(lambda m, qq, mm: J.make_knn_fn(cfg, map_cfg, m)(qq, mm))(
        m_s, J.jnp.asarray(q), J.jnp.asarray(mask))
    _nb, sq, found = J.jhm.knn_search(m_s, map_cfg, J.jnp.asarray(q), 5)
    n_unsat = int(np.sum(~np.asarray(found)[:, -1]
                         | (np.asarray(sq)[:, -1] > (0.5 * map_cfg.cell_size) ** 2)))
    Q = J.jnp.asarray(init["Q"])
    out = J.jax.jit(lambda *a: J.lio_step(cfg, map_cfg, *a, do_update=True))(
        xs, Ps, m_s, cs, Q, *_jins(ins2))
    return q, [np.asarray(a) for a in knn], n_unsat, out


@pytest.mark.parametrize("name", list(w.CASES))
def test_sharded_step_matches_jax(name, eight_ranks):
    q, (_nb_j, sq_j, f_j), n_unsat, out_j = _jax_case(name)
    _single, packed_j, dropped_j = _jax_round1()
    ranks = eight_ranks.result()
    got = ranks[0][name]

    # the insert-only round: the global layout is the port's single map, bit
    # for bit; against the JAX package's sharded map the same live slots and
    # counters, and coordinates to f64 roundoff (module docstring)
    np.testing.assert_array_equal(got["packed"], ranks[0]["single_round1_packed"])
    B = packed_j.shape[1] // 4
    np.testing.assert_array_equal(got["packed"][:, 3 * B:], packed_j[:, 3 * B:])
    np.testing.assert_allclose(got["packed"], packed_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["dropped"], dropped_j)
    # the merged kNN against JAX's single-table search; the narrow search
    # leaves some queries unsaturated, within the partial budget of 64 and
    # above 2, so each wide case picks the arm its name says.  The full wide
    # search runs in each (the step reads no count on the host), and the
    # rows it gives are picked on the device
    np.testing.assert_array_equal(got["queries"], q)
    N = len(q)
    assert 2 < n_unsat <= 64 < N
    assert got["wide_sizes"] == {"standard": [], "wide_fallback": [N],
                                 "wide_partial_compaction": [N],
                                 "wide_overflow": [N]}[name]
    np.testing.assert_array_equal(got["found"], f_j)
    np.testing.assert_allclose(np.where(np.isfinite(got["sq"]), got["sq"], -1),
                               np.where(np.isfinite(sq_j), sq_j, -1),
                               rtol=0, atol=1e-11)
    if name != "standard":  # all found after the wide search
        assert f_j.all()
    # the update round against JAX's single-device step
    assert got["map_size"] == int(out_j[6]["map_size"])
    assert got["n_eff"] == int(out_j[6]["n_eff"])
    x_j = tst.State(*(torch.tensor(np.asarray(v)) for v in out_j[0]))
    x_t = tst.State(**{f: torch.tensor(v) for f, v in got["x"].items()})
    np.testing.assert_allclose(tst.boxminus(x_t, x_j).numpy(), 0.0, atol=1e-8)
    np.testing.assert_allclose(got["P"], np.asarray(out_j[1]), rtol=0,
                               atol=1e-8)
    # the state is replicated: every rank holds the same bits
    for r in ranks[1:]:
        for f, v in got["x"].items():
            np.testing.assert_array_equal(r[name]["x"][f], v)
        np.testing.assert_array_equal(r[name]["packed"], got["packed"])


@pytest.mark.parametrize("name", list(w.CASES))
def test_host_branch_sharded_gates_equal_the_masked_step_and_jax(
        name, eight_ranks):
    """The sharded step's gates (each IF node a host branch) on the 8 gloo
    ranks: bit for bit the masked step, every rank seeing the same
    predicates in the same order (so on NCCL ranks every rank runs or skips
    each conditional node's collectives together), some of them False (the
    loop's condition after its last pass, a prune of a cube that did not
    move), and the state within
    1e-8 of JAX's single-device step."""
    out_j = _jax_case(name)[3]
    ranks = eight_ranks.result()
    for r in ranks:
        g = r[name]["gated"]
        assert g["equal"] == dict(x=True, P=True, map=True, diag=True)
        assert g["same_on_every_rank"] and g["ifs"] == ranks[0][name][
            "gated"]["ifs"]
        assert 0 < g["skipped"] < g["ifs"]
    g = ranks[0][name]["gated"]
    assert g["iters"] == int(out_j[6]["iters"])
    x_j = tst.State(*(torch.tensor(np.asarray(v)) for v in out_j[0]))
    x_t = tst.State(**{f: torch.tensor(v) for f, v in g["x"].items()})
    np.testing.assert_allclose(tst.boxminus(x_t, x_j).numpy(), 0.0, atol=1e-8)


@pytest.mark.parametrize("name", list(w.CASES))
def test_one_rank_step_equals_unsharded_step(name, eight_ranks):
    assert eight_ranks.result()[0]["one_rank"][name] == dict(
        x=True, P=True, map=True, diag=True)


def test_dryrun_on_eight_cpu_ranks(eight_ranks):
    """``dryrun_rank``'s checks passed on every rank (it raises otherwise),
    and the ranks agree."""
    runs = [r["dryrun"] for r in eight_ranks.result()]
    assert [r["rank"] for r in runs] == list(range(WORLD))
    assert all({k: v for k, v in r.items() if k != "rank"}
               == {k: v for k, v in runs[0].items() if k != "rank"}
               for r in runs)
    assert runs[0]["world"] == WORLD and runs[0]["transport"] == "gloo"
    assert runs[0]["n_eff_single"] > 0 and runs[0]["max_dx"] < 5e-3


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_local_map_cfg_and_owner_match_jax(n):
    J = _jax()
    cfg_t = thm.make_config(voxel_size=0.5, h_log2=15)
    cfg_j = J.jhm.make_config(voxel_size=0.5, h_log2=15)
    lt, lj = tshd.local_map_cfg(cfg_t, n), J.jshd.local_map_cfg(cfg_j, n)
    assert tuple(lt) == tuple(lj)
    small = tshd.local_map_cfg(thm.make_config(voxel_size=0.5, h_log2=5), n)
    assert small.h_log2 == max(5 - (n.bit_length() - 1), 4)
    rng = np.random.default_rng(40 + n)
    cells = rng.integers(-2**20, 2**20, size=(4096, 3)).astype(np.int32)
    cells[:8] = [[0, 0, 0], [-1, -1, -1], [2**20, 0, -2**20], [1, 2, 3],
                 [-7, 0, 7], [2**30, 2**30, 2**30], [-2**31, 0, 0],
                 [2**31 - 1, -2**31, 5]]
    got = tshd.owner_of(torch.tensor(cells), lt, n)
    want = J.jshd._owner_of(J.jnp.asarray(cells), lj, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= set(range(n))


def test_merge_candidates_matches_jax_merge():
    """The re-top-k of 8 ranks' candidates against JAX's ``_merge`` under
    ``shard_map``, on blocks full of ties (distances from {0, 1, 2, 3}) and
    missing neighbours (+inf): the same distances, and the same neighbour
    picked among tied ones."""
    J = _jax()
    rng = np.random.default_rng(41)
    N, k = 64, 5
    sq = np.sort(rng.integers(0, 4, size=(WORLD, N, k)).astype(np.float64), -1)
    sq[rng.random((WORLD, N, k)) < 0.2] = np.inf
    sq = np.sort(sq, -1)
    sq[:, :3] = np.inf  # queries no rank found anything for
    nbrs = rng.normal(size=(WORLD, N, k, 3))
    got = tshd.merge_candidates(torch.tensor(nbrs), torch.tensor(sq), k)

    mesh = J.Mesh(np.asarray(J.jax.devices()[:WORLD]), (J.jshd.AXIS,))
    ax = J.P(J.jshd.AXIS)
    merged = J.jax.jit(J.jax.shard_map(
        lambda a, b: J.jshd._merge(a, b, k), mesh=mesh, in_specs=(ax, ax),
        out_specs=(J.P(), J.P(), J.P()), check_vma=False))
    want = merged(J.jnp.asarray(nbrs.reshape(WORLD * N, k, 3)),
                  J.jnp.asarray(sq.reshape(WORLD * N, k)))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert not got[2][:3].any() and got[2].sum() > 0


def test_global_layout_splits_by_rank():
    """``split_global_map`` takes rank r's rows and counter of the global
    layout; a layout of another world size is refused."""
    packed = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    dropped = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    parts = [tshd.split_global_map(packed, dropped, r, 4) for r in range(4)]
    assert torch.equal(torch.cat([p.packed for p in parts]), packed)
    assert [int(p.dropped) for p in parts] == [3, 5, 7, 9]
    assert all(p.dropped.shape == (1,) for p in parts)
    with pytest.raises(ValueError, match="not sharded 2 ways"):
        tshd.split_global_map(packed, dropped, 0, 2)
    with pytest.raises(ValueError, match="not sharded 4 ways"):
        tshd.split_global_map(packed, dropped[0], 0, 4)


@pytest.mark.parametrize("world", [0, 3, 6])
def test_world_size_must_be_a_power_of_two(world, tmp_path):
    with pytest.raises(ValueError, match="power of two"):
        tshd.local_map_cfg(thm.make_config(voxel_size=0.5), world)
    with pytest.raises(ValueError, match="power of two"):
        init_distributed(f"file://{tmp_path}/store", world, 0, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        launch(w.one_rank_against_unsharded, world, device="cpu")
    assert not (tmp_path / "store").exists()  # refused before any rendezvous


def test_launch_raises_when_a_rank_fails(tmp_path):
    """A rank that raises ends the launch at once (its peer, waiting in a
    collective, is stopped), with the rank's traceback."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch(w.fails_on_rank_one, 2, device="cpu", store_dir=tmp_path,
               timeout_s=60.0)
    assert "rank one gives up" in str(err.value)
    assert time.monotonic() - t0 < 60.0
    assert list(tmp_path.iterdir()) == []  # the rendezvous directory went


def test_ranks_run_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device: the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(f"file://{tmp_path}/store", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tshd.dryrun(1)


@pytest.mark.cuda
def test_cuda_one_nccl_rank_equals_unsharded_run():
    """On a card: a small sim run through one NCCL rank of the sharded
    pipeline and through the unsharded pipeline, both captured (the
    default), within 5 mm per scan (the sharded step is other code than
    the unsharded one and is not held to it bit for bit; where the two
    would part is not measured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = launch(w.one_rank_against_unsharded, 1, backend="nccl")[0]
    assert res["transport"] == "nccl" and res["device"].startswith("cuda")
    assert res["sharded"].shape == res["unsharded"].shape
    assert np.isfinite(res["sharded"]).all()
    assert np.abs(res["sharded"] - res["unsharded"]).max() <= POS_TOL_M


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_cuda_collectives_inside_an_if_node(world):
    """On NCCL ranks, one card each: an all-reduce and an all-gather
    recorded inside a CUDA-graph IF node (``multicard.if_node_rank``) run
    where the predicate holds and leave their outputs alone where it does
    not, on every rank."""
    from fast_lio_tpu_torch.tools import multicard as mc

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    res = launch(mc.if_node_rank, world, backend="nccl", timeout_s=300.0)
    for r in res:
        assert r["error"] is None, r["error"]
        assert [p["flag"] for p in r["replays"]] == list(mc.IF_PROBE_FLAGS)
        assert all(p["ok"] for p in r["replays"]), r["replays"]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_cuda_collectives_inside_a_while_node(world):
    """On NCCL ranks, one card each: an all-reduce and an all-gather
    recorded inside the body of a CUDA-graph WHILE node
    (``multicard.while_node_rank``) run once a pass, 1, 3 and 5 passes a
    replay, on every rank, and the device counts those passes."""
    from fast_lio_tpu_torch.tools import multicard as mc

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    res = launch(mc.while_node_rank, world, backend="nccl", timeout_s=300.0)
    for r in res:
        assert r["error"] is None, r["error"]
        assert [p["passes"] for p in r["replays"]] == list(
            mc.WHILE_PROBE_PASSES)
        assert all(p["ok"] for p in r["replays"]), r["replays"]
