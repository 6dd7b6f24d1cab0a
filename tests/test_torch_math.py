"""so3, s2 and state of the port against the JAX package, in f64 and f32.

Inputs are made with numpy from a seed and fed to both.  Tolerances: f64
results agree to 1e-12 (same formulas, same operation order; only libm
transcendentals may differ in the last bit); f32 results to 2e-6 relative
(a few ulp: XLA may fuse a multiply-add that PyTorch rounds twice).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_lio_tpu import state as jst
from fast_lio_tpu.math import s2 as js2
from fast_lio_tpu.math import so3 as jso3
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.math import s2 as ts2
from fast_lio_tpu_torch.math import so3 as tso3

DTYPES = {"f64": (np.float64, torch.float64, 1e-12, 1e-12),
          "f32": (np.float32, torch.float32, 2e-6, 2e-6)}


def _rotvecs(rng, n, np_dt):
    """Rotation vectors spanning the Taylor branch (|v|^2 < 1e-8), the
    switch-over and large angles up to ~pi."""
    scales = np.concatenate([np.full(n // 4, 1e-6), np.full(n // 4, 1.2e-4),
                             np.full(n // 4, 0.3), np.full(n - 3 * (n // 4), 3.0)])
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    v = dirs * scales[:, None] * rng.uniform(0.5, 1.0, size=(n, 1))
    v[0] = 0.0  # exact zero
    return v.astype(np_dt)


def _quats(rng, n, np_dt):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np_dt)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_so3_matches_jax(dt):
    np_dt, t_dt, rtol, atol = DTYPES[dt]
    rng = np.random.default_rng(11)
    v = _rotvecs(rng, 64, np_dt)
    q1, q2 = _quats(rng, 64, np_dt), _quats(rng, 64, np_dt)
    pts = rng.normal(size=(64, 3)).astype(np_dt) * 20
    tv, tq1, tq2, tp = (torch.tensor(a) for a in (v, q1, q2, pts))

    _close(tso3.so3_exp(tv), jso3.so3_exp(jnp.asarray(v)), rtol, atol)
    _close(tso3.so3_exp_matrix(tv), jso3.so3_exp_matrix(jnp.asarray(v)), rtol, atol)
    _close(tso3.A_matrix(tv), jso3.A_matrix(jnp.asarray(v)), rtol, atol)
    _close(tso3.hat(tv), jso3.hat(jnp.asarray(v)), 0, 0)
    _close(tso3.so3_log(tq1), jso3.so3_log(jnp.asarray(q1)), rtol, atol)
    _close(tso3.quat_multiply(tq1, tq2),
           jso3.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)), rtol, atol)
    _close(tso3.quat_rotate(tq1, tp),
           jso3.quat_rotate(jnp.asarray(q1), jnp.asarray(pts)), rtol, 20 * atol)
    _close(tso3.quat_conjugate(tq1), jso3.quat_conjugate(jnp.asarray(q1)), 0, 0)
    _close(tso3.quat_to_matrix(tq1), jso3.quat_to_matrix(jnp.asarray(q1)),
           rtol, atol)
    R = np.asarray(jso3.quat_to_matrix(jnp.asarray(q1)))
    _close(tso3.matrix_to_quat(torch.tensor(R)),
           jso3.matrix_to_quat(jnp.asarray(R)), rtol, atol)
    # euler angles are in degrees (x57.3): scale the absolute tolerance
    _close(tso3.quat_to_euler_deg(tq1), jso3.quat_to_euler_deg(jnp.asarray(q1)),
           rtol, 100 * atol)
    assert tso3.so3_exp(tv).dtype == t_dt


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_so3_log_of_q_and_minus_q_agree(dt):
    np_dt, _t_dt, rtol, atol = DTYPES[dt]
    q = _quats(np.random.default_rng(12), 32, np_dt)
    a = tso3.so3_log(torch.tensor(q))
    b = tso3.so3_log(torch.tensor(-q))
    _close(a, b.numpy(), rtol, atol)
    _close(b, jso3.so3_log(jnp.asarray(-q)), rtol, atol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_s2_matches_jax(dt):
    np_dt, _t_dt, rtol, atol = DTYPES[dt]
    rng = np.random.default_rng(13)
    L = jst.S2_LENGTH
    g = rng.normal(size=(32, 3))
    g[0] = [-L, 0.0, 0.0]  # degenerate tangent basis (vec ~ -len e_x)
    g = (g / np.linalg.norm(g, axis=-1, keepdims=True) * L).astype(np_dt)
    h = rng.normal(size=(32, 3))
    h = (h / np.linalg.norm(h, axis=-1, keepdims=True) * L).astype(np_dt)
    h[1] = g[1]  # zero difference
    d2 = (rng.normal(size=(32, 2)) * 0.1).astype(np_dt)
    d2[2] = 0.0  # small-delta branch of mx
    d3 = (rng.normal(size=(32, 3)) * 0.1).astype(np_dt)
    tg, th, td2, td3 = (torch.tensor(a) for a in (g, h, d2, d3))
    jg, jh, jd2, jd3 = (jnp.asarray(a) for a in (g, h, d2, d3))

    _close(ts2.bx(tg, L), js2.bx(jg, L), rtol, atol)
    _close(ts2.boxplus(tg, td2, L), js2.boxplus(jg, jd2, L), rtol, 10 * atol)
    _close(ts2.oplus(tg, td3, 0.5), js2.oplus(jg, jd3, 0.5), rtol, 10 * atol)
    _close(ts2.boxminus(tg, th, L), js2.boxminus(jg, jh, L), rtol, atol)
    _close(ts2.nx_yy(tg, L), js2.nx_yy(jg, L), rtol, atol)
    _close(ts2.mx(tg, td2, L), js2.mx(jg, jd2, L), rtol, 10 * atol)


def _rand_states(rng, np_dt):
    """A JAX and a port state, equal, at a random point of the manifold."""
    dx = rng.normal(size=23) * 0.4
    js = jst.boxplus(jst.identity_state(jnp.float64), jnp.asarray(dx))
    arrays = [np.asarray(v).astype(np_dt) for v in js]
    return (jst.State(*(jnp.asarray(a) for a in arrays)),
            tst.State(*(torch.tensor(a) for a in arrays)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_state_ops_match_jax(dt):
    np_dt, _t_dt, rtol, atol = DTYPES[dt]
    rng = np.random.default_rng(14)
    ja, ta = _rand_states(rng, np_dt)
    jb, tb = _rand_states(rng, np_dt)
    dx = (rng.normal(size=23) * 0.05).astype(np_dt)
    f = (rng.normal(size=24) * 0.5).astype(np_dt)

    _close(tst.boxminus(ta, tb), jst.boxminus(ja, jb), rtol, 10 * atol)
    for got, want in zip(tst.boxplus(ta, torch.tensor(dx)),
                         jst.boxplus(ja, jnp.asarray(dx))):
        _close(got, want, rtol, 10 * atol)
    for got, want in zip(tst.oplus(ta, torch.tensor(f), 0.01),
                         jst.oplus(ja, jnp.asarray(f), 0.01)):
        _close(got, want, rtol, 10 * atol)
    g = (rng.normal(size=3) * 3).astype(np_dt)
    _close(tst.normalize_grav(torch.tensor(g)),
           jst.normalize_grav(jnp.asarray(g)), rtol, atol)


def test_state_constants_and_identity():
    assert tst.S2_LENGTH == jst.S2_LENGTH == 9.809
    assert tst.G_M_S2 == jst.G_M_S2 == 9.81
    assert tst.S2_LENGTH != tst.G_M_S2
    for name in ("DOF", "DIM", "NOISE_DOF", "H_COLS", "IDX_POS", "IDX_ROT",
                 "IDX_EXT_R", "IDX_EXT_T", "IDX_VEL", "IDX_BG", "IDX_BA",
                 "IDX_GRAV", "SO3_BLOCKS", "S2_BLOCKS", "VECT_BLOCKS"):
        assert getattr(tst, name) == getattr(jst, name), name
    assert tst.State._fields == jst.State._fields
    for got, want in zip(tst.identity_state(torch.float64),
                         jst.identity_state(jnp.float64)):
        _close(got, want, 0, 0)
