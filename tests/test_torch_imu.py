"""IMU propagation and deskew of the port against the JAX package.

The cases of tests/test_imu.py that shape the padded IMU block: a stale
prefix (samples before the previous scan end), padded slots holding garbage,
and ``deskew=False`` (MARSIM), each on a random rotating, accelerating
platform, in f64 and f32.

Tolerances: the port chains the per-interval quaternions and the (F, G)
covariance products with JAX's associative scan, in its association order
(``control_flow.associative_scan``), so only the products' own rounding
differs (XLA's and torch's matmuls and fused multiply-adds): f64 state and
points to 1e-10, P to 1e-10 relative; f32 state to 1e-6 and points to 1e-5
(m, rad; measured 3.7e-8 and 1.9e-6, the carry 2.4e-7), P to 2e-5 relative
(measured 4.2e-6).  The sequential loops the port ran before needed 2e-5
and 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_lio_tpu import imu as jimu
from fast_lio_tpu import state as jst
from fast_lio_tpu.filter import process as jproc
from fast_lio_tpu_torch import imu as timu
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.filter import process as tproc
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOLS = {"f64": (np.float64, torch.float64, 1e-10, 1e-10),
        "f32": (np.float32, torch.float32, 1e-6, 2e-5)}


def _block(case, np_dt, rng):
    """One padded IMU block + scan, as numpy arrays."""
    M, n = 24, 15
    t = np.linspace(-0.02, 0.1, n)
    last_end = 0.0
    if case != "stale_prefix":
        t = np.linspace(0.0, 0.1, n)
        last_end = -0.005
    omega = np.array([0.3, -0.5, 1.2])
    acc = np.tile([0.4, -0.2, jst.S2_LENGTH], (n, 1)) + rng.normal(0, 0.05, (n, 3))
    gyr = np.tile(omega, (n, 1)) + rng.normal(0, 0.01, (n, 3))
    imu_t = np.concatenate([t, np.full(M - n, t[-1])])
    mask = np.arange(M) < n
    acc = np.concatenate([acc, np.full((M - n, 3), 777.0)])  # garbage pads
    gyr = np.concatenate([gyr, np.full((M - n, 3), -555.0)])
    pts = rng.normal(size=(64, 3)) * 10
    ptt = np.sort(rng.uniform(0.0, 0.1, 64))
    carry = (rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.1)
    arrays = dict(imu_t=imu_t, acc=acc, gyr=gyr, pts=pts, ptt=ptt,
                  c0=carry[0], c1=carry[1])
    out = {k: v.astype(np_dt) for k, v in arrays.items()}
    out.update(mask=mask, last_end=last_end, pcl_end=0.1)
    return out


def _state(np_dt, rng):
    dx = rng.normal(size=23) * 0.2
    dx[21:23] = 0.0
    js = jst.boxplus(jst.identity_state(jnp.float64), jnp.asarray(dx))
    js = js._replace(grav=jnp.asarray([0.1, 0.2, -1.0]) / np.linalg.norm(
        [0.1, 0.2, -1.0]) * jst.S2_LENGTH)
    return [np.asarray(v).astype(np_dt) for v in js]


@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("case", ["padded", "stale_prefix", "no_deskew"])
def test_propagate_and_deskew_matches_jax(case, dt):
    np_dt, t_dt, tol, ptol = TOLS[dt]
    rng = np.random.default_rng(31)
    xs = _state(np_dt, rng)
    b = _block(case, np_dt, rng)
    P = (np.eye(23) * 1e-3).astype(np_dt)
    deskew = case != "no_deskew"

    jQ = jproc.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, jnp.dtype(np_dt))
    jout = jax.jit(jimu.propagate_and_deskew, static_argnames="deskew")(
        jst.State(*(jnp.asarray(a) for a in xs)), jnp.asarray(P), jQ,
        jnp.asarray(b["imu_t"]), jnp.asarray(b["acc"]), jnp.asarray(b["gyr"]),
        jnp.asarray(b["mask"]), jnp.asarray(1.01, np_dt),
        jnp.asarray(b["last_end"], np_dt), jnp.asarray(b["pcl_end"], np_dt),
        jimu.ImuCarry(jnp.asarray(b["c0"]), jnp.asarray(b["c1"])),
        jnp.asarray(b["pts"]), jnp.asarray(b["ptt"]), deskew=deskew)

    tQ = tproc.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, t_dt)
    tout = timu.propagate_and_deskew(
        tst.State(*(torch.tensor(a) for a in xs)), torch.tensor(P), tQ,
        torch.tensor(b["imu_t"]), torch.tensor(b["acc"]), torch.tensor(b["gyr"]),
        torch.tensor(b["mask"]), torch.tensor(1.01, dtype=t_dt),
        torch.tensor(b["last_end"], dtype=t_dt),
        torch.tensor(b["pcl_end"], dtype=t_dt),
        timu.ImuCarry(torch.tensor(b["c0"]), torch.tensor(b["c1"])),
        torch.tensor(b["pts"]), torch.tensor(b["ptt"]), deskew=deskew)

    (jx, jP, jpts, jcarry), (tx, tP, tpts, tcarry) = jout, tout
    for name, got, want in zip(tst.State._fields, tx, jx):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=ptol,
                               atol=ptol * float(np.abs(np.asarray(jP)).max()))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=tol,
                               atol=10 * tol)
    for got, want in zip(tcarry, jcarry):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
    assert tpts.dtype == t_dt


def test_static_init_helpers_match_jax():
    rng = np.random.default_rng(32)
    js, ts = jimu.empty_stats(), timu.empty_stats()
    for _ in range(3):
        acc = rng.normal([0.1, -0.2, 9.7], 0.05, (10, 3))
        gyr = rng.normal(0.0, 0.01, (10, 3))
        js, ts = jimu.update_stats(js, acc, gyr), timu.update_stats(ts, acc, gyr)
    assert js.n == ts.n
    for a, b in zip(js[1:], ts[1:]):
        np.testing.assert_array_equal(a, b)
    R = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    T = np.asarray([0.04, -0.02, 0.1])
    jx, jP = jimu.make_init_state(js, R, T, jnp.float64)
    tx, tP = timu.make_init_state(ts, R, T, torch.float64)
    for got, want in zip(tx, jx):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))
