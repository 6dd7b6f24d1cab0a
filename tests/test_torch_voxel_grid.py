"""Voxel downsample of the port against the JAX package, on all three key
paths: the fused single key (det_range-40 class bound), the two-key sort
(det_range-450 class bound) and the exact 3-key lexsort (no bound).

Masks and output order must be exact (the same stable sorts), and the
centroids and averaged features bit-equal: the port's plain segment sums
(``kernels.segment_sum.segment_mean_plain``) add each voxel's points in
sorted order, in sequence, as JAX's sorted ``segment_sum`` does on the CPU
(the kernel, on a card, is held bit for bit to the plain version in
``tests/test_torch_segment_sum.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_lio_tpu.ops import voxel_grid as jvg
from fast_lio_tpu_torch.ops import voxel_grid as tvg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# name: (coordinate half-span of the cloud in m, coord_bound passed)
PATHS = {
    "fused_key": (40.0, 40.0 * 1.25 + 5.0),
    "two_keys": (450.0, 450.0 * 1.25 + 5.0),
    "lexsort": (60.0, None),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_voxel_downsample_matches_jax(path):
    span, bound = PATHS[path]
    rng = np.random.default_rng(41)
    N, n_out, leaf = 4096, 1024, 0.5
    # clustered cloud so voxels hold several points, plus far scatter
    centers = rng.uniform(-span, span, size=(300, 3))
    pts = centers[rng.integers(0, 300, N)] + rng.normal(0, 0.4, (N, 3))
    pts = pts.astype(np.float32)
    mask = rng.uniform(size=N) < 0.9
    feats = rng.uniform(0, 255, N).astype(np.float32)

    jc, jm, jf = jvg.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), leaf,
                                      n_out, feats=jnp.asarray(feats),
                                      coord_bound=bound)
    tc, tm, tf = tvg.voxel_downsample(torch.tensor(pts), torch.tensor(mask),
                                      leaf, n_out, feats=torch.tensor(feats),
                                      coord_bound=bound)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert jm.all()  # more voxels than n_out: the overflow cut is exercised
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_voxel_downsample_without_feats_and_sparse_output():
    rng = np.random.default_rng(42)
    pts = rng.normal(0, 3.0, (512, 3)).astype(np.float32)
    mask = np.arange(512) < 300
    jc, jm = jvg.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 1.0, 512,
                                  coord_bound=55.0)
    tc, tm = tvg.voxel_downsample(torch.tensor(pts), torch.tensor(mask), 1.0,
                                  512, coord_bound=55.0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < int(tm.sum()) < 300
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
