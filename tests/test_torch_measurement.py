"""Plane fit and the point-to-plane measurement of the port against the JAX
package: planar, noisy, near-collinear, coincident and incomplete
neighbourhoods; re-search on and off; extrinsic estimation on and off.

Masks (plane_ok, selected, valid) must be equal.  Values agree to 1e-10 in
f64 (same formulas and order) and to 5e-5 in f32 (a normal from two
inverse-iteration solves on a 3x3 system amplifies the last-bit
differences of f32 rounding where XLA fuses a multiply-add).  A rejected
plane's coefficients are never used, so they are compared only where the
plane was accepted.  An exactly collinear set is left out: it has no unique
plane, and both packages return a normal decided by rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_lio_tpu import state as jst
from fast_lio_tpu.ops import measurement as jmeas
from fast_lio_tpu.ops import plane_fit as jpf
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.ops import measurement as tmeas
from fast_lio_tpu_torch.ops import plane_fit as tpf
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOLS = {"f64": (np.float64, 1e-10), "f32": (np.float32, 5e-5)}


def _neighbourhoods(rng, centers):
    """(N, 5, 3) neighbours around ``centers`` and a found mask, cycling
    through planar, off-plane, near-collinear, coincident and incomplete
    sets."""
    N = len(centers)
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1 = np.cross(n, rng.normal(size=(N, 3)))
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    ab = rng.uniform(-0.4, 0.4, size=(N, 5, 2))
    nbrs = (centers[:, None, :] + ab[..., :1] * t1[:, None] + ab[..., 1:] * t2[:, None]
            + rng.normal(0, 0.005, (N, 5, 1)) * n[:, None])
    found = np.ones((N, 5), bool)
    kind = np.arange(N) % 6
    nbrs[kind == 1, 2] += 0.5 * n[kind == 1]  # one neighbour off the plane
    line = centers[:, None, :] + np.linspace(-0.3, 0.3, 5)[None, :, None] * t1[:, None]
    line[:, 4] += 0.05 * t2  # one point 5 cm off the line: a thin plane
    nbrs[kind == 2] = line[kind == 2]  # near-collinear
    nbrs[kind == 3] = centers[kind == 3, None, :]  # coincident
    found[kind == 4, 3:] = False  # incomplete
    return nbrs, found


@pytest.mark.parametrize("dt", sorted(TOLS))
def test_fit_plane_matches_jax(dt):
    np_dt, tol = TOLS[dt]
    rng = np.random.default_rng(71)
    nbrs, found = _neighbourhoods(rng, rng.uniform(-30, 30, (240, 3)))
    nbrs = nbrs.astype(np_dt)
    jp, jok = jpf.fit_plane(jnp.asarray(nbrs), jnp.asarray(found), 0.1)
    tp, tok = tpf.fit_plane(torch.tensor(nbrs), torch.tensor(found), 0.1)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert 0 < jok.sum() < len(jok)
    ok = jok
    np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], rtol=tol,
                               atol=tol * 30)  # offsets scale with |p| ~ 30 m


def _states(np_dt, rng):
    dx = rng.normal(size=23) * 0.3
    js = jst.boxplus(jst.identity_state(jnp.float64), jnp.asarray(dx))
    arrays = [np.asarray(v).astype(np_dt) for v in js]
    return (jst.State(*(jnp.asarray(a) for a in arrays)),
            tst.State(*(torch.tensor(a) for a in arrays)))


@pytest.mark.parametrize("dt", sorted(TOLS))
@pytest.mark.parametrize("extrinsic_est", [True, False])
def test_compute_measurement_matches_jax(extrinsic_est, dt):
    np_dt, tol = TOLS[dt]
    rng = np.random.default_rng(72)
    N = 240
    js, ts = _states(np_dt, rng)
    pts = (rng.normal(size=(N, 3)) * 8).astype(np_dt)
    mask = np.arange(N) < 220
    p_world = np.asarray(jmeas.body_to_world(js, jnp.asarray(pts)))
    np.testing.assert_allclose(tmeas.body_to_world(ts, torch.tensor(pts)).numpy(),
                               p_world, rtol=tol, atol=tol * 10)
    nbrs, found = _neighbourhoods(rng, p_world.astype(np.float64))
    nbrs = nbrs.astype(np_dt)
    sq = ((nbrs - p_world[:, None, :]) ** 2).sum(-1)
    sq[::7, 4] = 6.0  # beyond the 5 m^2 gate
    sq = np.where(found, sq, np.inf).astype(np_dt)
    row_mask = rng.uniform(size=N) < 0.9

    def t_knn(q, m):
        return torch.tensor(nbrs), torch.tensor(sq), torch.tensor(found)

    # the neighbourhoods enter as arguments, not closure constants: XLA
    # would fold the plane fit at compile time, with other arithmetic
    @jax.jit
    def j_step(x, cache, conv, nb, d2, fd):
        return jmeas.compute_measurement(
            x, jnp.asarray(pts), jnp.asarray(mask), lambda q, m: (nb, d2, fd),
            cache, conv, extrinsic_est, jnp.asarray(row_mask))

    jc = jmeas.empty_cache(N, jnp.dtype(np_dt))
    tc = tmeas.empty_cache(N, getattr(torch, np.dtype(np_dt).name))
    # re-search at the first state, then a cached pass at a moved state
    js2, ts2 = _states(np_dt, np.random.default_rng(73))
    for conv, jx, tx in ((True, js, ts), (False, js2, ts2)):
        jout = j_step(jx, jc, jnp.asarray(conv), jnp.asarray(nbrs),
                      jnp.asarray(sq), jnp.asarray(found))
        tout = tmeas.compute_measurement(
            tx, torch.tensor(pts), torch.tensor(mask), t_knn, tc, conv,
            extrinsic_est, torch.tensor(row_mask))
        jh_x, jh, jsel, jc, jvalid, jpw = jout
        th_x, th, tsel, tc, tvalid, tpw = tout
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        assert bool(tvalid) == bool(jvalid) and bool(tvalid)
        np.testing.assert_allclose(th_x.numpy(), np.asarray(jh_x), rtol=tol,
                                   atol=tol * 30)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol,
                                   atol=tol * 30)
        np.testing.assert_allclose(tpw.numpy(), np.asarray(jpw), rtol=tol,
                                   atol=tol * 30)
        ok = tc.plane_ok.numpy()
        for name, a, b in zip(tmeas.NeighborCache._fields, tc, jc):
            if a.dtype == torch.bool:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
            else:
                a, b = a.numpy(), np.asarray(b)
                if name == "pabcd":
                    a, b = a[ok], b[ok]
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol * 30,
                                           err_msg=name)
        assert not th_x[:, 6:9].any() if not extrinsic_est else th_x[:, 6:9].any()
