"""The region-grouped kNN search of the port: its plain version against the
JAX package's grouped Pallas kernel (interpret mode, loaded as
tests/test_knn_grouped.py loads it) on that file's six search cases plus a
clamped out-of-range case; against the port's own per-query search bit for
bit where the region key is not clamped; the pipeline with
``knn_backend="grouped"``; the wrapper's host logic (the ring's stage count,
the prep's one-block limit); and on a GPU the prep kernel against
``group_queries`` and the search kernel against the plain version and the
per-query kernel, on coherent, shuffled, clamped and union-overflow scenes.

Rule against the Pallas kernel (tests/test_knn_grouped.py:37-59): found
masks equal, squared distances within rtol 1e-5 (atol 1e-6), neighbours
equal (1e-6) wherever the distances are distinct — the Pallas kernel picks
each neighbour by a one-hot sum and may order ties differently.  Against
the port's per-query search, which scores the same rows with the same
arithmetic in the same order, found, sq and the neighbours where found are
bit-equal.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.kernels import knn_grouped as tkg
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_knn import CUDA_N, CUDA_SCENES, cuda_scene
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = thm.MapConfig(h_log2=10, bucket_slots=16, cell_size=1.0, voxel_size=0.5)


@functools.cache
def _jax_side():
    """(jnp, the JAX hash_map, knn_search_grouped), imported on first use:
    the CUDA cases run on a GPU host without JAX."""
    import jax.numpy as jnp

    from fast_lio_tpu.map import hash_map as jhm

    p = Path(__file__).resolve().parent.parent / "tools" / "knn_grouped.py"
    spec = importlib.util.spec_from_file_location("knn_grouped", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return jnp, jhm, mod.knn_search_grouped


def _port_map(points, cfg=CFG, device="cpu"):
    on = torch.ones(len(points), dtype=torch.bool, device=device)
    m = thm.make_map(cfg, torch.float32, device)
    return thm.insert(m, cfg, torch.tensor(points, device=device), on, on)


def _scene(case, rng):
    """Map points and queries of tests/test_knn_grouped.py's cases (same
    shapes and distributions, this file's seed), plus 'clamped'."""
    if case == "clusters":  # ~15 queries per storage cell
        pts = rng.uniform(-6, 6, size=(4000, 3))
        centers = rng.uniform(-5, 5, size=(12, 3))
        q = np.concatenate([c + rng.uniform(-0.45, 0.45, size=(15, 3))
                            for c in centers])
    elif case == "all_distinct":  # every query in its own cell
        pts = rng.uniform(-8, 8, size=(2000, 3))
        g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
        q = (g.reshape(-1, 3) * 2.0 - 4.0 + rng.uniform(0.1, 0.9, (64, 3)))
    elif case == "sparse_and_empty":
        pts = np.concatenate([
            rng.uniform(-2, 2, size=(500, 3)),
            [[8.0, 8.0, 8.0], [8.3, 8.0, 8.0], [-7.0, 5.0, 0.0]]])
        q = np.concatenate([
            rng.uniform(-2, 2, size=(16, 3)),
            [[8.1, 8.0, 8.0], [20.0, 20.0, 20.0], [-7.2, 5.1, 0.0]],
            np.zeros((13, 3))])
    elif case == "wide":
        pts = rng.uniform(-4, 4, size=(800, 3))
        centers = rng.uniform(-3, 3, size=(6, 3))
        q = np.concatenate([c + rng.uniform(-0.45, 0.45, size=(8, 3))
                            for c in centers])
    elif case == "not_multiple_of_8":
        pts = rng.uniform(-3, 3, size=(600, 3))
        q = rng.uniform(-3, 3, size=(37, 3))
    elif case == "tie_lattice":
        pts = np.stack(np.meshgrid(*[np.arange(6) * 0.5] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
        q = pts[::7] + 0.25
    else:  # clamped: x beyond 512 cells, where the 10-bit key saturates
        pts = np.concatenate([
            rng.uniform([598, -2, -2], [602, 2, 2], size=(300, 3)),
            rng.uniform([698, -2, -2], [702, 2, 2], size=(300, 3))])
        q = np.concatenate([
            rng.uniform([599.6, -0.4, -0.4], [600.4, 0.4, 0.4], size=(3, 3)),
            rng.uniform([699.6, -0.4, -0.4], [700.4, 0.4, 0.4], size=(3, 3))])
    return pts.astype(np.float32), q.astype(np.float32)


def _rule(got, ref):
    nb_g, sq_g, f_g = (np.asarray(a) for a in got)
    nb_r, sq_r, f_r = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(f_g, f_r)
    np.testing.assert_allclose(np.where(f_r, sq_g, 0.0),
                               np.where(f_r, sq_r, 0.0), rtol=1e-5, atol=1e-6)
    sq_f = np.where(f_r, sq_r, -1.0)  # missing entries tie with nothing
    tied = (np.abs(sq_f[:, :, None] - sq_f[:, None, :]) < 1e-9).sum(-1) > 1
    strict = f_r & ~tied
    np.testing.assert_allclose(nb_g[strict], nb_r[strict], rtol=1e-6,
                               atol=1e-6)


def _bit_equal(got, ref):
    nb_g, sq_g, f_g = (t.cpu() for t in got)
    nb_r, sq_r, f_r = (t.cpu() for t in ref)
    assert torch.equal(f_g, f_r)
    assert torch.equal(sq_g, sq_r)
    assert torch.equal(nb_g[f_r], nb_r[f_r])


CASES = ["clusters", "all_distinct", "sparse_and_empty", "wide",
         "not_multiple_of_8", "tie_lattice", "clamped"]


@pytest.mark.parametrize("case", CASES)
def test_plain_grouped_matches_jax_grouped_kernel(case):
    rng = np.random.default_rng(71)
    pts, q = _scene(case, rng)
    wide = case == "wide"
    tm = _port_map(pts)
    got = tkg.knn_search_grouped_plain(tm, CFG, torch.tensor(q), wide=wide)
    jnp, jhm, knn_search_grouped = _jax_side()
    jm = jhm.Map(packed=jnp.asarray(tm.packed.numpy()),
                 dropped=jnp.asarray(tm.dropped.numpy()))
    ref = knn_search_grouped(jm, jhm.MapConfig(*CFG), jnp.asarray(q),
                             wide=wide, interpret=True)
    _rule([t.numpy() for t in got], ref)
    assert got[2].any()
    per_query = thm.knn_search(tm, CFG, torch.tensor(q), wide=wide)
    if case == "clamped":
        # the queries near x = 700 share a key with those near x = 600 and
        # search the head's rows: the TPU kernel's semantics, kept
        assert not torch.equal(got[2], per_query[2])
        assert not got[2][3:].any() and per_query[2][3:].all()
    else:
        _bit_equal(got, per_query)


def test_grouping_machinery():
    """Groups break at every key change and every 8th query of a run; each
    group holds 1-8 queries; the order is a stable sort by key."""
    rng = np.random.default_rng(72)
    q = np.concatenate([np.full((19, 3), 0.2), rng.uniform(-3, 3, (13, 3)),
                        np.full((3, 3), 0.3)]).astype(np.float32)
    qt = torch.tensor(q)
    grp = tkg.group_queries(qt, CFG)
    key = tkg.region_key(thm.region_base(qt, CFG))
    order = grp.order.numpy()
    assert (np.diff(key.numpy()[order]) >= 0).all()
    n = int(grp.n_groups[0])
    starts = grp.starts.numpy()[:n]
    sizes = np.diff(np.append(starts, len(q)))
    assert starts[0] == 0 and (sizes >= 1).all() and (sizes <= 8).all()
    # the 22 queries of the cell at 0.2 / 0.3 are one key: groups 8, 8, 6
    ks = key.numpy()[order]
    run = ks == tkg.region_key(thm.region_base(qt[:1], CFG)).item()
    first = int(np.argmax(run))
    assert run.sum() == 22
    assert list(sizes[np.searchsorted(starts, first):][:3]) == [8, 8, 6]
    assert np.array_equal(grp.gid.numpy(),
                          np.searchsorted(starts, np.arange(len(q)),
                                          side="right") - 1)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(73)
    pts, q = _scene("clusters", rng)
    tm = _port_map(pts)
    before = dict(tkg.launches)
    for wide in (False, True):
        got = tkg.knn_search(tm, CFG, torch.tensor(q), wide=wide)
        want = tkg.knn_search_grouped_plain(tm, CFG, torch.tensor(q),
                                            wide=wide)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tkg.launches == before  # no kernel launch on CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        tkg.knn_search_cuda(tm.packed, CFG, torch.tensor(q))
    empty = tkg.knn_search(tm, CFG, torch.zeros((0, 3)))
    assert [tuple(t.shape) for t in empty] == [(0, 5, 3), (0, 5), (0, 5)]


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


@pytest.mark.parametrize("wide_fallback", [False, True])
def test_pipeline_grouped_backend_equals_default(wide_fallback, monkeypatch):
    """On the CPU the grouped backend's plain version gives the default
    backend's positions bit for bit, through the narrow and (with the wide
    fallback and a small compaction budget) the wide searches."""
    calls = []
    search = tkg.knn_search

    def counting(m, cfg, q, k=5, wide=False):
        calls.append(wide)
        return search(m, cfg, q, k=k, wide=wide)

    monkeypatch.setattr(tkg, "knn_search", counting)
    cfg = tcfg.Config(
        lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
        filter_size_map=0.3, n_points_max=2048, n_ds_max=1024, n_imu_max=32,
        map_h_log2=12, det_range=40.0, cube_side_length=300.0,
        knn_wide_fallback=wide_fallback, map_cell_multiplier=3,
        knn_wide_max_queries=64)
    data = tsim.generate(tsim.SimConfig(duration=1.2, n_rings=8,
                                        n_azimuth=200, range_noise=0.01))
    default = tpipe.Pipeline(cfg, device="cpu")
    _feed(default, data)
    assert not calls
    grouped = tpipe.Pipeline(dataclasses.replace(cfg, knn_backend="grouped"),
                             device="cpu")
    _feed(grouped, data)
    assert False in calls and (True in calls) == wide_fallback
    p_d = np.stack([p for _, p, _ in default.get_trajectory()])
    p_g = np.stack([p for _, p, _ in grouped.get_trajectory()])
    assert len(p_d) >= 10
    np.testing.assert_array_equal(p_g, p_d)
    with pytest.raises(ValueError, match="knn_backend"):
        tpipe.Pipeline(dataclasses.replace(cfg, knn_backend="bogus"),
                       device="cpu")


@pytest.mark.cuda
def test_cuda_grouped_backend_equals_default_when_deterministic():
    """On the card under ``torch.use_deterministic_algorithms(True)``
    (``index_add_`` then sums in a fixed order) two default-backend runs and
    a grouped-backend run give the same positions bit for bit, through the
    narrow and wide searches.  With PyTorch's defaults the runs spread by a
    few mm (``chip_smoke.py`` phase 6), which is the scatter order, not the
    backend."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernels have no CPU mode")
    cfg = tcfg.Config(
        lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
        filter_size_map=0.3, n_points_max=2048, n_ds_max=1024, n_imu_max=32,
        map_h_log2=12, det_range=40.0, cube_side_length=300.0,
        knn_wide_fallback=True, map_cell_multiplier=3,
        knn_wide_max_queries=64)
    data = tsim.generate(tsim.SimConfig(duration=1.2, n_rings=8,
                                        n_azimuth=200, range_noise=0.01))
    before = dict(tkg.launches)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for backend in ("auto", "auto", "grouped"):
            pipe = tpipe.Pipeline(dataclasses.replace(cfg, knn_backend=backend))
            _feed(pipe, data)
            runs.append(np.stack([p for _, p, _ in pipe.get_trajectory()]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(tkg.launches[r] > before[r] for r in (8, 27))
    assert len(runs[0]) >= 10
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])


def _gpu_scene(scene, B):
    """A clustered scene, or _scene's clamped one, at bucket width B, on
    the card."""
    cfg = CFG._replace(bucket_slots=B)
    if scene == "clamped":
        pts, q = _scene("clamped", np.random.default_rng(71))
    else:
        rng = np.random.default_rng(74)
        pts = rng.uniform(-6, 6, size=(6000, 3)).astype(np.float32)
        centers = rng.uniform(-5, 5, size=(40, 3))
        q = np.concatenate([c + rng.uniform(-0.45, 0.45, size=(15, 3))
                            for c in centers])
        q = np.concatenate([q, rng.uniform(-6, 6, size=(301, 3))]).astype(
            np.float32)
    return cfg, _port_map(pts, cfg, "cuda"), torch.tensor(q, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["clustered", "clamped"])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [16, 64, 128])
def test_cuda_grouped_kernel_matches_plain_version(B, wide, scene):
    """B = 128 with R = 27 needs 54 KB of shared memory per block, above
    the 48 KB default.  On clamped keys the kernel searches the head's rows,
    as its plain version does on the card and on the CPU (bit for bit), and
    so differs from the per-query kernel, which finds every neighbour of
    the queries near x = 700 (at R = 8 the grouped search finds none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    cfg, tm, qc = _gpu_scene(scene, B)
    r = 27 if wide else 8
    before = tkg.launches[r]
    got = tkg.knn_search(tm, cfg, qc, wide=wide)
    torch.cuda.synchronize()
    assert tkg.launches[r] == before + 1
    _bit_equal(got, tkg.knn_search_grouped_plain(tm, cfg, qc, wide=wide))
    tm_cpu = thm.Map(packed=tm.packed.cpu(), dropped=tm.dropped.cpu())
    _bit_equal(got, tkg.knn_search_grouped_plain(tm_cpu, cfg, qc.cpu(),
                                                 wide=wide))
    per_query = tknn.knn_search_cuda(tm.packed, cfg, qc, wide=wide)
    if scene == "clamped":
        assert per_query[2].all() and got[2][:3].all()
        assert not torch.equal(got[2], per_query[2])
        assert wide or not got[2][3:].any()
    else:
        _bit_equal(got, per_query)
        assert got[2].any()


@pytest.mark.parametrize("R, B, stages", [
    (8, 16, 4), (8, 64, 4), (8, 128, 4), (27, 16, 4), (27, 64, 4),
    (27, 128, 2), (27, 256, 2)])
def test_search_stages_per_region_and_width(R, B, stages):
    """As many stages of R rows as 112 KB hold (two blocks share an SM),
    2 to 4; R = 27 at B = 128 takes two stages, 108 KB."""
    assert tkg.search_stages(R, B) == stages
    assert stages * R * 16 * B <= (tkg.MAX_SHARED_BYTES
                                   - tkg.STATIC_SHARED_BYTES)


def test_search_refuses_rows_whose_two_stages_do_not_fit():
    with pytest.raises(ValueError, match="more than a block has"):
        tkg.search_stages(27, 512)


@pytest.mark.parametrize("n", [0, tkg.PREP_MAX_QUERIES + 1])
def test_prep_refuses_what_one_block_does_not_sort(n):
    """The prep kernel groups 1..PREP_MAX_QUERIES queries, and the grouped
    search refuses more, before either looks at the device (CPU tensors
    here); a size it sorts on the CPU is refused for its device."""
    q = torch.zeros((n, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="one block"):
        tkg.group_queries_cuda(q, CFG)
    if n:
        with pytest.raises(ValueError, match="one block"):
            tkg.knn_search_cuda(thm.make_map(CFG).packed, CFG, q)
    with pytest.raises(ValueError, match="CUDA"):
        tkg.group_queries_cuda(torch.zeros((5, 3)), CFG)


def test_grouped_backend_refuses_searches_above_the_prep():
    """A scan's searches hold up to n_ds_max queries: the grouped backend
    takes at most what the prep kernel sorts, on either device."""
    cfg = dataclasses.replace(tcfg.PRESETS["avia"], knn_backend="grouped")
    tpipe.Pipeline(cfg, device="cpu")  # n_ds_max 8192
    big = dataclasses.replace(cfg, n_ds_max=tkg.PREP_MAX_QUERIES + 1)
    with pytest.raises(ValueError, match="n_ds_max"):
        tpipe.Pipeline(big, device="cpu")
    with pytest.raises(ValueError, match="n_ds_max"):
        tpipe.make_knn_fn(big, CFG, thm.make_map(CFG))
    tpipe.Pipeline(dataclasses.replace(big, knn_backend="auto"), device="cpu")


def _groups_equal(got, want):
    """The prep kernel's groups against group_queries', bit for bit: what
    the search reads (order, the first n_groups starts, n_groups); each
    sorted query's group, rebuilt from those starts, is group_queries'."""
    n = int(want.n_groups[0])
    assert int(got.n_groups[0]) == n
    assert got.gid is None
    assert torch.equal(got.order.long().cpu(), want.order.long().cpu())
    starts = got.starts[:n].cpu()
    assert torch.equal(starts, want.starts[:n].cpu())
    assert n >= 1 and int(starts[0]) == 0
    gid = torch.searchsorted(starts.long(),
                             torch.arange(len(got.order)), right=True) - 1
    assert torch.equal(gid, want.gid.long().cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("scene", CUDA_SCENES)
def test_cuda_prep_kernel_equals_group_queries(scene, wide):
    """order, the group starts and n_groups, at every N of CUDA_N up to
    one block, against group_queries on the CPU (IEEE
    division, as the kernel divides) and on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prep kernel has no CPU mode")
    _cfg, _tm, q = cuda_scene(scene, 16)
    r = 27 if wide else 8
    for n in [n for n in CUDA_N if n <= tkg.PREP_MAX_QUERIES]:
        qn = q[:n].contiguous()
        before = tkg.prep_launches[r]
        got = tkg.group_queries_cuda(qn, CFG, wide)
        torch.cuda.synchronize()
        assert tkg.prep_launches[r] == before + 1
        _groups_equal(got, tkg.group_queries(qn.cpu(), CFG, wide))
        _groups_equal(got, tkg.group_queries(qn, CFG, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [16, 64, 128])
@pytest.mark.parametrize("scene", CUDA_SCENES)
def test_cuda_grouped_search_on_scenes(scene, B, wide):
    """At N = 1, 7, 8, 9, 33 and 8192: two launches a search (prep and
    search), bit-equal to the plain version on the card and on the CPU, and
    to the per-query kernel where no key is clamped; at 8193, more than the
    prep's one block sorts, it raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernels have no CPU mode")
    cfg, tm, q = cuda_scene(scene, B)
    tm_cpu = thm.Map(packed=tm.packed.cpu(), dropped=tm.dropped.cpu())
    r = 27 if wide else 8
    for n in CUDA_N:
        qn = q[:n].contiguous()
        before = (tkg.launches[r], tkg.prep_launches[r])
        if n > tkg.PREP_MAX_QUERIES:
            with pytest.raises(ValueError, match="one block"):
                tkg.knn_search(tm, cfg, qn, wide=wide)
            assert (tkg.launches[r], tkg.prep_launches[r]) == before
            continue
        got = tkg.knn_search(tm, cfg, qn, wide=wide)
        torch.cuda.synchronize()
        assert (tkg.launches[r], tkg.prep_launches[r]) \
            == (before[0] + 1, before[1] + 1)
        _bit_equal(got, tkg.knn_search_grouped_plain(tm, cfg, qn, wide=wide))
        _bit_equal(got, tkg.knn_search_grouped_plain(tm_cpu, cfg, qn.cpu(),
                                                     wide=wide))
        if scene != "clamped":
            _bit_equal(got, tknn.knn_search_cuda(tm.packed, cfg, qn,
                                                 wide=wide))
