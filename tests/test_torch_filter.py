"""Process model and iEKF of the port against the JAX package.

In f64 the port must reproduce the JAX filter: x, P to 1e-10 (the same
algebra; only BLAS summation order differs) and the same iteration count,
for a fixed synthetic nonlinear measurement model whose Jacobian is only
recomputed when the filter asks for a re-search (``converge``), so the
``while_loop`` control flow (forced re-search, exits, invalid passes) is
what the comparison exercises.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_lio_tpu import state as jst
from fast_lio_tpu.filter import ekf as jekf
from fast_lio_tpu.filter import process as jproc
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.filter import ekf as tekf
from fast_lio_tpu_torch.filter import process as tproc
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-10


def _states(dx, scale=1.0):
    js = jst.boxplus(jst.identity_state(jnp.float64), jnp.asarray(dx * scale))
    arrays = [np.asarray(v) for v in js]
    return (jst.State(*(jnp.asarray(a) for a in arrays)),
            tst.State(*(torch.tensor(a) for a in arrays)))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _spd(rng, n, scale):
    A = rng.normal(size=(n, n))
    return A @ A.T * scale / n + np.eye(n) * 1e-3


def test_process_model_matches_jax():
    rng = np.random.default_rng(21)
    js, ts = _states(rng.normal(size=23), 0.5)
    acc = rng.normal(size=3) + [0, 0, 9.8]
    gyr = rng.normal(size=3)
    ta, tg = torch.tensor(acc), torch.tensor(gyr)
    ja, jg = jnp.asarray(acc), jnp.asarray(gyr)
    _close(tproc.f_dynamics(ts, ta, tg), jproc.f_dynamics(js, ja, jg))
    _close(tproc.df_dx(ts, ta, tg), jproc.df_dx(js, ja, jg))
    _close(tproc.df_dw(ts), jproc.df_dw(js))
    _close(tproc.process_noise_cov(0.1, 0.2, 1e-4, 2e-4, torch.float64),
           jproc.process_noise_cov(0.1, 0.2, 1e-4, 2e-4, jnp.float64), 0)


def test_predict_matches_jax_single_and_batched():
    rng = np.random.default_rng(22)
    Q = rng.uniform(0.01, 0.2, 12)
    P = _spd(rng, 23, 0.1)
    xs, accs, gyrs, dts = [], [], [], []
    for _ in range(4):
        xs.append(_states(rng.normal(size=23), 0.3))
        accs.append(rng.normal(size=3) + [0, 0, 9.8])
        gyrs.append(rng.normal(size=3) * 0.5)
        dts.append(rng.uniform(1e-3, 1e-2))
    jQ, tQ = jnp.diag(jnp.asarray(Q)), torch.diag(torch.tensor(Q))
    for (js, ts), a, g, dt in zip(xs, accs, gyrs, dts):
        jx, jP = jekf.predict(js, jnp.asarray(P), dt, jQ, jnp.asarray(a),
                              jnp.asarray(g))
        tx, tP = tekf.predict(ts, torch.tensor(P), dt, tQ, torch.tensor(a),
                              torch.tensor(g))
        for got, want in zip(tx, jx):
            _close(got, want)
        _close(tP, jP)
    # predict_matrices takes a leading batch dimension (the IMU block)
    tb = tst.State(*(torch.stack(f) for f in zip(*(t for _, t in xs))))
    F, Fw, f = tekf.predict_matrices(tb, torch.tensor(dts, dtype=torch.float64),
                                     torch.tensor(np.stack(accs)),
                                     torch.tensor(np.stack(gyrs)))
    for k, ((js, _ts), a, g, dt) in enumerate(zip(xs, accs, gyrs, dts)):
        jF, jFw, jf = jekf.predict_matrices(js, dt, jnp.asarray(a), jnp.asarray(g))
        _close(F[k], jF)
        _close(Fw[k], jFw)
        _close(f[k], jf)


def test_spd_solve_and_block_transform_match_jax():
    rng = np.random.default_rng(23)
    A, B = _spd(rng, 23, 1.0), rng.normal(size=(23, 23))
    _close(tekf._spd_solve(torch.tensor(A), torch.tensor(B)),
           jekf._spd_solve(jnp.asarray(A), jnp.asarray(B)), 1e-9)
    dx = rng.normal(size=23) * 0.1
    (ja, ta), (jb, tb) = _states(rng.normal(size=23), 0.3), _states(
        rng.normal(size=23), 0.3)
    _close(tekf._block_transform(torch.tensor(dx), ta, tb),
           jekf._block_transform(jnp.asarray(dx), ja, jb))


class _JCarry(NamedTuple):
    H: jnp.ndarray
    calls: jnp.ndarray


def _models(H0, mask, x_true_j, x_true_t, invalid_calls):
    """The same measurement model in both frameworks: residual of a
    nonlinear function of the first 12 error coordinates; its Jacobian is
    refreshed only when ``converge`` is set (the kNN re-search analog).
    Calls listed in ``invalid_calls`` report valid=False."""
    bad = np.asarray(sorted(invalid_calls) or [-1])

    def j_fn(x, converge, carry):
        e = jst.boxminus(x_true_j, x)[:12]
        H = jnp.where(converge, jnp.asarray(H0) * (1.0 + 0.2 * jnp.cos(e)),
                      carry.H)
        z = H @ e
        h = z + 0.05 * jnp.sin(z)
        valid = ~jnp.any(carry.calls == jnp.asarray(bad))
        return jekf.MeasOut(H, h, jnp.asarray(mask), valid,
                            _JCarry(H, carry.calls + 1))

    def t_fn(x, converge, carry):
        H_old, calls = carry
        e = tst.boxminus(x_true_t, x)[:12]
        H = torch.tensor(H0) * (1.0 + 0.2 * torch.cos(e)) if converge else H_old
        z = H @ e
        h = z + 0.05 * torch.sin(z)
        valid = torch.tensor(calls not in invalid_calls)
        return tekf.MeasOut(H, h, torch.tensor(mask), valid, (H, calls + 1))

    return j_fn, t_fn


CASES = {
    # name: (max_iter, epsi, invalid calls)
    "converges": (3, 1e-3, ()),
    "never_converges_forced_research": (5, 1e-14, ()),
    "invalid_pass_keeps_x": (4, 1e-3, (1,)),
    "all_invalid": (3, 1e-3, (0, 1, 2, 3)),
    "single_lap": (0, 1e-3, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_iterated_matches_jax(case):
    max_iter, epsi, invalid = CASES[case]
    rng = np.random.default_rng(24)
    N = 96
    H0 = rng.normal(size=(N, 12))
    mask = rng.uniform(size=N) < 0.8
    dx0 = rng.normal(size=23) * 0.05
    jx0, tx0 = _states(dx0)
    dxt = dx0.copy()
    dxt[:12] += rng.normal(size=12) * 0.03
    jxt, txt = _states(dxt)
    P0 = _spd(rng, 23, 0.1)
    R = 1e-3
    j_fn, t_fn = _models(H0, mask, jxt, txt, invalid)

    jres = jax.jit(lambda x, P: jekf.update_iterated(
        x, P, j_fn, _JCarry(jnp.zeros((N, 12)), jnp.asarray(0, jnp.int32)),
        R, max_iter, epsi))(jx0, jnp.asarray(P0))
    tres = tekf.update_iterated(tx0, torch.tensor(P0), t_fn,
                                (torch.zeros(N, 12, dtype=torch.float64), 0),
                                R, max_iter, epsi)

    assert tres.iterations == int(jres.iterations)
    assert tres.valid == bool(jres.valid)
    for got, want in zip(tres.x, jres.x):
        _close(got, want)
    _close(tres.P, jres.P)
    _close(tres.carry[0], jres.carry.H)  # the same re-searches happened
    assert tres.carry[1] == int(jres.carry.calls)
    if case == "all_invalid":
        _close(tres.P, P0, 0)
