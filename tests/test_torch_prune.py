"""The local map's prune with removals, end to end: the prune's hall
(``tools/scenarios.prune_run``, velodyne_outdoor's run with a 10 m range and
a 32 m local-map cube, cut to 128 columns, 2048/1024-point pads and 1.5 s)
in float64 through the JAX pipeline and the port's, on the CPU.

The cube slides as the sensor circles the hall, and the prune frees the
map points it leaves.  Tolerances: in float64 the two pipelines do the same
arithmetic (``tests/test_torch_pipeline.py``), so per-scan positions agree
to 1e-6 m and the map's size and drops are equal.  The same run with a
1000 m cube, which never slides, holds more points: the prune removed some.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu.pipeline import Pipeline as JPipeline
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.tools import scenarios
from test_torch_bench import _jax_config
from test_torch_pipeline import _feed, _positions
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS_TOL_M = 1e-6
DURATION_S = 1.5  # 14 scans: the cube first slides, and prunes, at the 11th


@pytest.fixture(scope="module")
def runs():
    """The port's run with the 32 m cube, JAX's on the same data, and the
    port's with a 1000 m cube (one torch thread, as ``one_torch_thread``
    gives each test)."""
    cfg, data = scenarios.prune_run(full=False, duration=DURATION_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = tpipe.Pipeline(cfg, device="cpu")
        _feed(port, data)
        jax_pipe = JPipeline(_jax_config(cfg))
        _feed(jax_pipe, data)
        wide = tpipe.Pipeline(dataclasses.replace(
            cfg, cube_side_length=scenarios.NO_PRUNE_CUBE_SIDE),
            device="cpu")
        _feed(wide, data)
    finally:
        torch.set_num_threads(threads)
    return port, jax_pipe, wide


def test_pruned_run_matches_jax(runs):
    port, jax_pipe, _ = runs
    assert port.cfg.compute_dtype == "float64"
    pos_t, pos_j = _positions(port), _positions(jax_pipe)
    assert len(pos_t) == len(pos_j) >= 12
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=POS_TOL_M)
    ht, hj = port.health_check(), jax_pipe.health_check()
    assert (ht["map_size"], ht["map_dropped"]) == (hj["map_size"],
                                                   hj["map_dropped"])
    assert [int(d.map_size) for d in port.diags] == [
        int(d.map_size) for d in jax_pipe.diags]


def test_prune_removes_points(runs):
    """The map with the sliding cube holds fewer points than the run whose
    cube never slides, and its size fell from one scan to the next: the
    prune freed points the insert had kept."""
    port, _, wide = runs
    pruned = port.health_check()["map_size"]
    assert pruned < wide.health_check()["map_size"]
    sizes = [int(d.map_size) for d in port.diags]
    assert any(b < a for a, b in zip(sizes, sizes[1:]))
    wide_sizes = [int(d.map_size) for d in wide.diags]
    assert all(b >= a for a, b in zip(wide_sizes, wide_sizes[1:]))
