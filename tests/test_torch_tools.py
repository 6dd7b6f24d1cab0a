"""The port's tools (``fast_lio_tpu_torch/tools/``: ``profile_scan``,
``microbench_knn``, ``bench_scaling``, ``scenarios``, ``oracle_compare``,
``oracle_ab``, ``eval_traj``, ``plot``, ``microbench_device``,
``profile_stages``; the bound and the build log): the parts that run
without a card, the tools that time the card at a tiny size on the CPU
(``--device cpu``), and the rule that the port imports no JAX."""
import ast
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import cli, pipeline, sim
from fast_lio_tpu_torch.kernels import bounds, build
from fast_lio_tpu_torch.math import so3
from fast_lio_tpu_torch.tools import (bench_scaling, eval_traj,
                                      microbench_device, microbench_knn,
                                      oracle_ab, oracle_compare, plot,
                                      profile_scan, profile_stages, scenarios)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),  # overlap, out of order
    ([(0.0, 4.0), (1.0, 2.0), (4.0, 5.0)], 5.0),  # nested, touching
])
def test_busy_time_is_the_union_of_intervals(intervals, busy):
    assert profile_scan._busy_us(intervals) == busy


def test_rejects_unknown_presets():
    with pytest.raises(SystemExit):
        profile_scan.main(["no_such_preset"])


def test_profile_runs_include_the_grouped_backend():
    grouped, base = (profile_scan.RUNS[n][0]
                     for n in ("ouster64_grouped", "ouster64"))
    assert grouped == dataclasses.replace(base, knn_backend="grouped")



@pytest.mark.parametrize("name, search, knn", [
    # an earlier tree's search kernels (profiled in turns with this one)
    ("void (anonymous namespace)::knn_kernel<8>(float const*, float const*,"
     " int, int, unsigned int, float, float, float*, float*, unsigned char*)",
     True, True),
    ("void (anonymous namespace)::knn_grouped_kernel<27>(float const*, ...)",
     True, True),
    # this tree's, the grouped search's prep included
    ("void (anonymous namespace)::knn_tile_kernel<27>(float const*, ...)",
     True, True),
    ("void (anonymous namespace)::knn_grouped_search_kernel<8>(float const*)",
     True, True),
    ("void (anonymous namespace)::knn_grouped_prep_kernel<1024>(float const*,"
     " int, float, float, int*, int*, int*, int*)", False, True),
    # torch's own kernels
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", False,
     False),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", False, False),
    ("void at::native::(anonymous namespace)::nonknn_kernel<1>()", False,
     False),
    ("Memset (Device)", False, False),
])
def test_knn_kernels_are_told_by_name(name, search, knn):
    assert profile_scan.is_knn_search_kernel(name) == search
    assert profile_scan.is_knn_prep_kernel(name) == (knn and not search)
    assert profile_scan.is_knn_kernel(name) == knn


def test_ptxas_usage_reads_registers_and_spills():
    log = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115knn_tile_kernelILi8EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115knn_tile_kernelILi8EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 17664 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115knn_tile_kernelILi27EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115knn_tile_kernelILi27EEEvPKf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
"""
    got = build.ptxas_usage(log)
    assert got == {
        "_ZN12_GLOBAL__N_115knn_tile_kernelILi8EEEvPKf": dict(
            registers=64, spill_stores=0, spill_loads=0, smem_bytes=17664),
        "_ZN12_GLOBAL__N_115knn_tile_kernelILi27EEEvPKf": dict(
            registers=255, spill_stores=12, spill_loads=16),
    }


def test_microbench_shuffles_the_main_path_queries():
    """The shuffled case holds the main case's queries in another order, on
    the same map."""
    main = microbench_knn.make_case("r27", "main", device="cpu")
    shuffled = microbench_knn.make_case("r27", "shuffled", device="cpu")
    assert main.queries.shape == (8192, 3) and main.wide
    assert torch.equal(main.m.packed, shuffled.m.packed)
    assert not torch.equal(main.queries, shuffled.queries)
    key = lambda q: q[np.lexsort(q.numpy().T)]  # noqa: E731
    assert torch.equal(key(main.queries), key(shuffled.queries))
    with pytest.raises(ValueError, match="order"):
        microbench_knn.make_case("r8", "sorted", device="cpu")


def test_microbench_float64_case_is_the_float32_case_off_its_grid():
    """The float64 case holds the float32 case's map and queries moved off
    the float32 grid (they round back to them), and its shuffled case the
    same queries in the float32 case's shuffled order."""
    f32 = microbench_knn.make_case("r27", "main", device="cpu")
    f64 = microbench_knn.make_case("r27", "main", device="cpu",
                                   dtype=torch.float64)
    s32 = microbench_knn.make_case("r27", "shuffled", device="cpu")
    s64 = microbench_knn.make_case("r27", "shuffled", device="cpu",
                                   dtype=torch.float64)
    assert f64.m.packed.dtype == f64.queries.dtype == torch.float64
    assert torch.equal(f64.m.packed.float(), f32.m.packed)
    assert torch.equal(f64.queries.float(), f32.queries)
    assert torch.equal(s64.queries.float(), s32.queries)
    assert torch.equal(s64.m.packed, f64.m.packed)
    key = lambda q: q[np.lexsort(q.numpy().T)]  # noqa: E731
    assert torch.equal(key(f64.queries), key(s64.queries))
    nz = f32.queries != 0
    assert bool((f64.queries.float().double() != f64.queries)[nz].all())
    with pytest.raises(ValueError, match="dtype"):
        microbench_knn.make_case("r8", device="cpu", dtype=torch.float16)


@pytest.mark.parametrize("tag", ["r8", "r27"])
def test_microbench_searches_what_the_main_path_searches(tag, monkeypatch):
    """The main case's queries are those ``pipeline.make_knn_fn`` hands its
    search for the downsampled scan: all n_ds_max slots, at R = 8 and, in
    the wide fallback, at R = 27."""
    case = microbench_knn.make_case(tag, device="cpu")
    preset, sim_cfg, wide, _seed = microbench_knn.CASES[tag]
    narrow = microbench_knn.main_path_queries(preset, *_scan(sim_cfg),
                                              device="cpu")
    seen = []
    search = pipeline.knn_kernel.knn_search

    def keep(m, cfg, q, wide=False):
        seen.append((q.clone(), wide))
        return search(m, cfg, q, wide=wide)

    monkeypatch.setattr(pipeline.knn_kernel, "knn_search", keep)
    valid = torch.ones(len(narrow), dtype=torch.bool)
    valid[(narrow == narrow[-1]).all(dim=1)] = False  # the zero pads
    pipeline.make_knn_fn(preset, case.cfg, case.m)(narrow, valid)
    searched = [q for q, w in seen if w == wide]
    assert len(searched) == 1 and torch.equal(searched[0], case.queries)
    assert case.queries.shape[0] == preset.n_ds_max


def _scan(sim_cfg):
    """(scan, rot, pos) of the scan the microbenchmark searches."""
    data = sim.generate(sim_cfg)
    k = microbench_knn.SCAN
    return data.scans[k], data.gt_rot[k], data.gt_pos[k]


@pytest.mark.parametrize("blind_windows", [0, 2, 3])
def test_kernel_time_tries_the_profiler_again_then_cuda_events(
        blind_windows, monkeypatch):
    """A profiler window that saw no kernel is tried again; after
    ``PROFILER_WINDOWS`` blind windows the graph's CUDA-event time stands in
    for ``device_us``, and ``device_timer`` says which clock gave it."""
    windows = []

    def profiled(fn, calls, is_kernel):
        windows.append(calls)
        if len(windows) <= blind_windows:
            return None, None, 0.0
        return 12.5, 3.0, 1.0

    monkeypatch.setattr(microbench_knn, "profiled_us", profiled)
    monkeypatch.setattr(microbench_knn, "graph_us", lambda fn: 20.0)
    t = microbench_knn.kernel_us(lambda: None, 7)
    tries = microbench_knn.PROFILER_WINDOWS
    assert windows == [7] * min(blind_windows + 1, tries)
    if blind_windows < tries:
        assert t == {"device_us": 12.5, "device_timer": "profiler",
                     "profiler_windows": blind_windows + 1,
                     "prep_device_us": 3.0, "launches_per_call": 1.0,
                     "graph_us": 20.0}
    else:
        assert t == {"device_us": 20.0, "device_timer": "cuda_events_graph",
                     "profiler_windows": tries, "prep_device_us": None,
                     "launches_per_call": 0.0, "graph_us": 20.0}


def test_microbench_measures_nothing_without_a_card(capsys):
    assert microbench_knn.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_prep_bound_is_its_bytes():
    """The queries in, and what the search reads: order, the n_groups
    starts, and their count."""
    got = bounds.prep_bound(8192, 1140)
    assert got.nbytes == 8192 * (12 + 4) + 1140 * 4 + 4 and got.by == "bytes"
    assert got.ms == got.nbytes / 3.35e12 * 1e3


def test_bench_scaling_trend_prints_a_line_per_configuration(capsys):
    """``--trend --device cpu`` at a tiny size: the unsharded run and gloo
    ranks 1 and 2, each a launch of worker processes, one JSON line each."""
    assert bench_scaling.main(["--trend", "--device", "cpu", "--ranks", "1,2",
                               "--scans", "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(ln["mode"], ln["n_ranks"]) for ln in lines] == [
        ("unsharded", 1), ("sharded_full", 1), ("sharded_full", 2)]
    assert all(ln["scans_per_sec"] > 0 and ln["platform"] == "cpu"
               and ln["transport"] == "gloo" for ln in lines)


def test_bench_scaling_measures_nothing_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    assert bench_scaling.main([]) == 1
    assert bench_scaling.main(["--ablate"]) == 1
    assert bench_scaling.main(["--eager"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _load_root_module(name):
    """A module of the repository root (``bench.py``, ``tools/*.py``) by
    path: they are scripts, not packages."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name.replace('/', '_')}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", scenarios.NAMES)
def test_scenarios_are_benchs(name):
    """Every Config field equal, and the sim runs bit-equal, to the JAX
    package's ``bench._scenario``."""
    want_cfg, want = _load_root_module("bench")._scenario(name)
    got_cfg, got = scenarios.scenario(name)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.scenario("kitti")


def test_batch_scenario_is_benchs_main_batch():
    """``avia_preset_batch4``: the AVIA preset (every Config field equal to the
    JAX package's) and bench.py's ``main_batch`` sim runs, seeds 0-3,
    bit-equal (at a 1 s duration)."""
    from fast_lio_tpu import sim as jsim
    from fast_lio_tpu.config import PRESETS as JPRESETS

    cfg, runs = scenarios.batch_scenario("avia_preset_batch4", duration=1.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JPRESETS["avia"])
    assert len(runs) == 4
    for s, got in enumerate(runs):
        want = jsim.generate(jsim.SimConfig(duration=1.0, n_rings=16,
                                            n_azimuth=400, seed=s))
        for x, y in zip(got.scans, want.scans):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(got.imu_acc, want.imu_acc)
        np.testing.assert_array_equal(got.gt_pos, want.gt_pos)
    # avia_batchN is the runner's fleet at bench.py's avia config
    for name in ("avia", "avia_batch4"):
        with pytest.raises(ValueError, match="unknown fleet scenario"):
            scenarios.batch_scenario(name)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's runner on a 1 s sim run (CPU, pose log on), and the sim's
    ground truth as a TUM file."""
    out = tmp_path_factory.mktemp("cli")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["--sim", "--duration", "1.0", "--platform", "cpu",
                         "--runtime-pos-log", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    data = sim.generate(sim.SimConfig(duration=1.0))
    quat = so3.matrix_to_quat(torch.tensor(data.gt_rot)).numpy()
    cli._write_tum(out / "gt_tum.txt",
                   zip(data.scan_stamps + 0.1, data.gt_pos, quat))
    return out


@pytest.mark.parametrize("align", [[], ["--align"]])
def test_eval_traj_prints_the_jax_tools_numbers(cli_run, capsys, align):
    args = [str(cli_run / "trajectory_tum.txt"), str(cli_run / "gt_tum.txt"),
            *align]
    assert eval_traj.main(args) == 0
    got = capsys.readouterr().out
    assert _load_root_module("tools/eval_traj").main(args) == 0
    want = capsys.readouterr().out
    assert got == want and "ATE RMSE" in got and "pairs: " in got


def test_plot_writes_its_pngs(cli_run, capsys):
    pytest.importorskip("matplotlib")
    assert plot.main(["--out", str(cli_run)]) == 0
    for png in ("state_evolution.png", "timing.png"):
        assert (cli_run / png).stat().st_size > 0
    assert "wrote" in capsys.readouterr().out
    assert plot.main([]) == 1


def test_oracle_compare_prints_the_jax_tools_lines(capsys):
    assert oracle_compare.main(["1", "--device", "cpu", "--dtype",
                                "float64"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "pipeline", "oracle[intended]", "oracle[reference]",
        "pipe vs oracle[intended]", "pipe vs oracle[reference]"]
    assert all(" mm p50 " in ln and " mrad p50 " in ln for ln in lines[3:])


def test_oracle_ab_prints_the_jax_tools_keys(capsys):
    assert oracle_ab.main(["mid360", "0.05", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(out) == {"scenario", "scans", "duration_s", "pipeline",
                        "oracle_quirks_f64", "ratio_aligned"}
    assert set(out["pipeline"]) == {"ate_aligned_m", "ate_raw_m", "wall_s"}
    assert set(out["oracle_quirks_f64"]) == {"ate_aligned_m", "ate_raw_m",
                                             "wall_s", "map_size"}
    assert out["scenario"] == "mid360" and out["scans"] >= 4


def test_microbench_device_prints_the_jax_tools_rows(capsys):
    assert microbench_device.main(["--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = ["knn XLA (gather+d2+top5+extract)", "gather 32768 rows 1KB",
             "elementwise 2MB r/w", "sort 32k int32",
             "top_k(5) of (4096,512)", "scatter 4096 scalars"]
    assert [ln[:48].rstrip() for ln in lines[:-1]] == names
    out = json.loads(lines[-1])
    assert list(out["rows"]) == names and out["device"] == "cpu"
    # no device time is claimed for a CPU run
    assert all(r["device_ms"] is None and r["host_ms"] > 0
               for r in out["rows"].values())


def test_profile_stages_prints_the_jax_tools_rows(capsys):
    assert profile_stages.main(["mid360", "--device", "cpu", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("scenario=mid360  pads: raw=1024 ds=512 imu=8")
    stages = [ln[:46].rstrip() for ln in lines[1:-2]]
    assert stages == [
        "imu propagate+deskew (8 knots, 1024 pts)",
        "voxel downsample (1024 -> 512)",
        "knn search (512 q, configured backend)",
        "measurement (knn+fit+H, 1 eval)", "full iterated update (3 iters)",
        "map insert (512)", "map prune (gated, rarely fires)"]
    assert lines[-2].startswith("host-bound total (imu+ds+update+insert)")
    out = json.loads(lines[-1])
    assert out["total_host_ms"] > 0 and "total_device_ms" not in out


def test_card_tools_run_on_cuda_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    assert microbench_device.main([]) == 1
    assert profile_stages.main([]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 2
    for tool, argv in ((oracle_compare, ["1"]), (oracle_ab, ["mid360", "0.05"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(argv)


def test_capture_cost_needs_a_card(capsys):
    from fast_lio_tpu_torch.tools import capture_cost
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    assert capture_cost.main(["avia"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_capture_cost_reads_the_body_pools_and_puts_torch_graph_back():
    """The body pools' bytes are every pool's segments, at every depth;
    the capture timer wraps ``torch.cuda.graph`` only while entered."""
    from types import SimpleNamespace

    from fast_lio_tpu_torch.tools import capture_cost

    def pool(*sizes):
        return SimpleNamespace(
            snapshot=lambda: [{"total_size": n} for n in sizes])

    fake = SimpleNamespace(_bodies={(0, 0): (None, pool(3, 5)),
                                    (0, 1): (None, pool(7)),
                                    (0, 2): (None, pool())})
    assert capture_cost.body_pool_bytes(fake) == 15
    real = torch.cuda.graph
    with capture_cost.CaptureTimer(fake) as timer:
        assert torch.cuda.graph is not real
        assert issubclass(torch.cuda.graph, real)
    assert torch.cuda.graph is real and timer.captures == []


# what the port may not import: JAX, the JAX package, and the repository
# root's scripts (``bench.py`` imports JAX; root ``tools/`` is the JAX
# package's), which are importable wherever the root is on ``sys.path``
# (``chip_smoke.py`` puts it there)
FORBIDDEN_TOPS = ("jax", "jaxlib", "fast_lio_tpu", "bench", "tools")
# calls that load a module from a file's path
LOADERS_BY_PATH = ("spec_from_file_location", "run_path", "SourceFileLoader",
                   "load_source")
ROOT_SCRIPT_PATH = re.compile(r"(\./)?(bench\.py|tools(/[\w.]*)?)")


def _called_name(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _docstrings(tree) -> set:
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax,
    fast_lio_tpu or the root's ``bench`` and ``tools``, by name or by
    path: they run on a card's host that has no JAX."""
    files = [*sorted((ROOT / "fast_lio_tpu_torch").rglob("*.py")),
             ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        where = path.relative_to(ROOT)
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call):
                called = _called_name(node)
                assert called not in LOADERS_BY_PATH, (
                    f"{where} loads a module by path ({called})")
                first = node.args[0] if node.args else None
                names = ([first.value] if called in (
                    "import_module", "__import__")
                    and isinstance(first, ast.Constant) else [])
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str) and id(node) not in docs):
                # a path to the root's scripts (a citation ends ":line")
                assert not ROOT_SCRIPT_PATH.fullmatch(node.value), (
                    f"{where} names the root's {node.value!r}")
                continue
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN_TOPS, (
                    f"{where} imports {name}")
