"""The port's measuring tools (``tools/profile_scan.py``,
``tools/microbench_knn.py``, the bound and the build log): the parts that
run without a card."""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import pipeline, sim
from fast_lio_tpu_torch.kernels import bounds, build
from fast_lio_tpu_torch.tools import microbench_knn, profile_scan
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


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
    assert main.queries.shape == (2048, 3) and main.wide
    assert torch.equal(main.m.packed, shuffled.m.packed)
    assert not torch.equal(main.queries, shuffled.queries)
    key = lambda q: q[np.lexsort(q.numpy().T)]  # noqa: E731
    assert torch.equal(key(main.queries), key(shuffled.queries))
    with pytest.raises(ValueError, match="order"):
        microbench_knn.make_case("r8", "sorted", device="cpu")


@pytest.mark.parametrize("tag", ["r8", "r27"])
def test_microbench_searches_what_the_main_path_searches(tag, monkeypatch):
    """The main case's queries are those ``pipeline.make_knn_fn`` hands its
    search for the downsampled scan: all n_ds_max slots at R = 8, and the
    compacted unsaturated ones at R = 27."""
    case = microbench_knn.make_case(tag, device="cpu")
    preset, sim_cfg, wide, _seed = microbench_knn.CASES[tag]
    narrow = microbench_knn.main_path_queries(
        preset, case.cfg, case.m, *_scan(sim_cfg), wide=False)
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
    assert case.queries.shape[0] == (preset.knn_wide_max_queries if wide
                                     else preset.n_ds_max)


def _scan(sim_cfg):
    """(scan, rot, pos) of the scan the microbenchmark searches."""
    data = sim.generate(sim_cfg)
    k = microbench_knn.SCAN
    return data.scans[k], data.gt_rot[k], data.gt_pos[k]


def test_microbench_measures_nothing_without_a_card(capsys):
    assert microbench_knn.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_prep_bound_is_its_bytes():
    """The queries in, and what the search reads: order, the n_groups
    starts, and their count."""
    got = bounds.prep_bound(8192, 1140)
    assert got.nbytes == 8192 * (12 + 4) + 1140 * 4 + 4 and got.by == "bytes"
    assert got.ms == got.nbytes / 3.35e12 * 1e3
