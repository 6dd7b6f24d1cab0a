"""On-manifold iterated error-state Kalman filter (iEKF) engine.

Port of ``fast_lio_tpu/filter/ekf.py`` (the esekfom engine, esekfom.hpp):

* ``predict`` — esekfom.hpp:279-383: mean via DIM-space retraction,
  covariance via per-block tangent-transported Jacobians.
* ``update_iterated`` — the modified dyn-share update (esekfom.hpp:1619-1931)
  in the 23x23 information form, where the only reductions over the N
  measurement rows are H^T H (12x12) and H^T h (12,).

The JAX ``while_loop`` becomes its most passes, ``max_iter + 1``, each
``control_flow.loop_pass(~done, pass, carry)`` on a carry of device
tensors: no host read.  In a captured step with gates (the single
pipeline, the batch, the sharded step on NCCL ranks) each pass is a
CUDA-graph IF node, so a replay runs the passes JAX's loop runs and skips
the rest: under ``torch.func.vmap`` (the batch) while any lane is active,
as JAX's batched ``while_loop`` runs, each lane keeping its own result only
while it is active itself.  In the masked form (eager, the CPU) every pass
runs and a pass after the exit leaves the carry as it was, through
``torch.where``.  Inside a pass a measurement with no valid point leaves
the iterate unchanged, as JAX's ``sel`` does.

Deviations carried over from the JAX package: the predict-step exp factors
use the mathematically intended scale (the reference's ``scalar(1/2)`` is 0,
esekfom.hpp:312,344), and the solves use a jittered Cholesky instead of
``.inverse()``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from .. import control_flow as cf
from .. import state as st
from ..math import s2, so3
from . import process


class MeasOut(NamedTuple):
    """Output of the measurement-model callback (the h_dyn_share analog).
    ``mask`` marks live rows; ``valid`` False means zero effective points
    (skip the iteration, laserMapping.cpp:708-713)."""

    h_x: torch.Tensor  # (N, 12) masked Jacobian rows
    h: torch.Tensor  # (N,)   masked residuals
    mask: torch.Tensor  # (N,)   bool, row validity
    valid: torch.Tensor  # ()     bool
    carry: Any  # opaque state threaded through iterations


MeasFn = Callable[[st.State, torch.Tensor, Any], MeasOut]
# signature: (x_iterate, converge_flag () bool, carry) -> MeasOut


def _dt_tensor(dt, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(dt, dtype=ref.dtype, device=ref.device)


def predict_matrices(x: st.State, dt, acc: torch.Tensor, gyro: torch.Tensor):
    """(F (…,23,23), Fw (…,23,12), f (…,24)) of one predict step at
    pre-state ``x``; leading batch dims on ``x``, ``dt``, ``acc``, ``gyro``.

    The gravity rows of f are identically zero (use-ikfom.hpp:47-59), so
    both tangent frames of the S2 diagonal block are evaluated at ``x.grav``.
    """
    dt = _dt_tensor(dt, x.pos)
    dt_v = dt[..., None]
    dt_m = dt[..., None, None]
    f = process.f_dynamics(x, acc, gyro)
    fx_rows = process.df_dx(x, acc, gyro)[..., :st.DOF, :]
    fw_rows = process.df_dw(x)[..., :st.DOF, :]

    R3, E3, G3 = st.IDX_ROT, st.IDX_EXT_R, st.IDX_GRAV
    # SO3 rows transported by A(-f_seg dt); S2 rows are identically zero
    A_rot = so3.A_matrix(-f[..., R3:R3 + 3] * dt_v)
    A_ext = so3.A_matrix(-f[..., E3:E3 + 3] * dt_v)
    fx_t = fx_rows.clone()
    fw_t = fw_rows.clone()
    for t, rows in ((fx_t, fx_rows), (fw_t, fw_rows)):
        t[..., R3:R3 + 3, :] = A_rot @ rows[..., R3:R3 + 3, :]
        t[..., E3:E3 + 3, :] = A_ext @ rows[..., E3:E3 + 3, :]
        t[..., G3:G3 + 2, :] = 0.0

    # diagonal manifold corrections (esekfom.hpp:303-357)
    # made from f, so that under vmap F is batched and takes the writes
    F = f.new_zeros(f.shape[:-1] + (st.DOF, st.DOF)) + torch.eye(
        st.DOF, dtype=f.dtype, device=f.device)
    F[..., R3:R3 + 3, R3:R3 + 3] = so3.so3_exp_matrix(-f[..., R3:R3 + 3] * dt_v)
    F[..., E3:E3 + 3, E3:E3 + 3] = so3.so3_exp_matrix(-f[..., E3:E3 + 3] * dt_v)
    R_s2 = so3.so3_exp_matrix(f[..., G3:G3 + 3] * dt_v)
    Nx = s2.nx_yy(x.grav, st.S2_LENGTH)
    Mx = s2.mx(x.grav, x.grav.new_zeros(x.grav.shape[:-1] + (2,)), st.S2_LENGTH)
    F[..., G3:G3 + 2, G3:G3 + 2] = Nx @ R_s2 @ Mx

    F = F + fx_t * dt_m
    Fw = fw_t * dt_m
    return F, Fw, f


def predict(x: st.State, P: torch.Tensor, dt, Q: torch.Tensor,
            acc: torch.Tensor, gyro: torch.Tensor) -> Tuple[st.State, torch.Tensor]:
    """One propagation step: x <- x.oplus(f dt);  P <- F P F^T + Fw Q Fw^T."""
    dt = _dt_tensor(dt, x.pos)
    F, Fw, f = predict_matrices(x, dt, acc, gyro)
    x_new = st.oplus(x, f, dt)
    P_new = F @ P @ F.T + Fw @ Q @ Fw.T
    return x_new, _sym(P_new)


def _block_transform(dx: torch.Tensor, x: st.State, x_prop: st.State) -> torch.Tensor:
    """23x23 block-diagonal tangent-frame transport T(dx): A(dx_blk)^T on
    the SO3 blocks (esekfom.hpp:1668), Nx_yy(x.grav) Mx(x_prop.grav, dx_blk)
    on the S2 block (esekfom.hpp:1687-1691), identity elsewhere."""
    T = dx.new_zeros((st.DOF, st.DOF)) + torch.eye(
        st.DOF, dtype=dx.dtype, device=dx.device)  # batched with dx
    for idx, _dim in st.SO3_BLOCKS:
        T[idx:idx + 3, idx:idx + 3] = so3.A_matrix(dx[idx:idx + 3]).T
    for idx, _dim in st.S2_BLOCKS:
        Nx = s2.nx_yy(x.grav, st.S2_LENGTH)
        Mx = s2.mx(x_prop.grav, dx[idx:idx + 2], st.S2_LENGTH)
        T[idx:idx + 2, idx:idx + 2] = Nx @ Mx
    return T


def _sym(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.transpose(-1, -2))


def _spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for SPD A via Cholesky, after symmetrizing and adding a
    relative diagonal jitter of 32 eps trace(A)/n (f32 safety; the reference
    runs f64 and skips this, esekfom.hpp:1924).  ``cholesky_ex`` neither
    raises nor syncs on a failed factorization, like jnp.linalg.cholesky."""
    n = A.shape[-1]
    A = _sym(A)
    eps = 32.0 * torch.finfo(A.dtype).eps
    jitter = eps * (torch.trace(A) / n)
    A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L, _info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)


class UpdateResult(NamedTuple):
    x: st.State
    P: torch.Tensor
    carry: Any  # final measurement carry (neighbor caches etc.)
    iterations: torch.Tensor  # () int32, number of h_fn evaluations
    valid: torch.Tensor  # () bool, whether any update was applied


@functools.lru_cache(maxsize=None)
def _constants(epsi, dtype: torch.dtype, device: torch.device):
    """(epsi, eye(DOF)) on the device, made once per (value, dtype, device):
    no host-to-device copy per call (none may run inside a CUDA graph).
    Read-only."""
    epsi = torch.as_tensor(epsi, dtype=dtype, device=device)
    return epsi, torch.eye(st.DOF, dtype=dtype, device=device)


def _hashable(v):
    """A float or a tuple of floats: the cache key of a scalar or vector."""
    a = np.asarray(v, dtype=np.float64)
    return float(a) if a.ndim == 0 else tuple(a.tolist())


def update_iterated(
    x: st.State,
    P: torch.Tensor,
    h_fn: MeasFn,
    carry0: Any,
    R: float,
    max_iter: int,
    epsi=0.001,
    group=None,
) -> UpdateResult:
    """The modified iterated update (esekfom.hpp:1619-1931).

    ``h_fn(x, converge, carry)`` plays ``h_dyn_share``; ``converge`` (a ()
    bool tensor) gates the kNN re-search exactly like ``ekfom_data.converge``
    (laserMapping.cpp:667).  The passes follow the JAX ``while_loop``
    (``fast_lio_tpu/filter/ekf.py:256-350``): ``converge`` starts True, the
    C++ loop variable ``i`` starts at -1, a re-search is forced at
    ``i == max_iter-2`` if no iteration has converged, the loop exits on
    ``t > 1`` or ``i == max_iter-1``, and a pass with ``valid`` False leaves
    the iterate unchanged (but still counts as an evaluation).  The loop
    makes at most ``max_iter + 1`` passes (``i`` from -1 while
    ``i < max_iter``); here each is ``control_flow.loop_pass(~done, pass,
    carry)``, the carry (``i``, ``t``, ``converge``, ``done``,
    ``any_valid``, ``n_evals``, the iterate, ``P_post``, ``dx_final``, the
    measurement carry) device tensors, made from ``P`` so that under
    ``torch.func.vmap`` they are batched like it.  In a gated capture a
    pass after ``done`` (after every lane's, in a batch) is an IF node that
    does not run; in the masked form it runs and leaves every carried value
    as it was.  Either way the results are the loop's, with no host read.

    ``group`` (a ``parallel.ShardGroup``): the measurement rows are split
    across its ranks, and each pass sums H^T H, H^T h and the ranks'
    ``valid`` flags over them in one ``all_reduce_sum`` — the JAX package's
    two ``psum`` (``fast_lio_tpu/filter/ekf.py:294-298``), elementwise sums
    alike.  ``valid`` joins the sum so that every rank masks the same
    passes by construction, not because each rank's own downsample gives
    the same flag.  So every pass's predicate is the same on every rank,
    and in a gated capture on NCCL ranks every rank runs or skips each
    pass, with its collectives, together.  Without a group nothing
    changes.
    """
    dtype, device = P.dtype, P.device
    epsi, eye = _constants(_hashable(epsi), dtype, device)
    x_prop, P_prop = x, P
    n = st.DOF

    def scalar(v, dt):  # batched like P under vmap, so a gated pass can
        return P_prop.new_full((), v, dtype=dt)  # write a lane's value

    i32 = torch.int32

    def one_pass(c):
        i, t, converge, done, any_valid, n_evals, x, P_post, dx_final, \
            h_carry = c
        out = h_fn(x, converge, h_carry)

        mrows = out.mask.to(dtype)
        h_x = out.h_x * mrows[:, None]
        h = out.h * mrows

        dx = st.boxminus(x, x_prop)
        T = _block_transform(dx, x, x_prop)
        dx_new = T @ dx
        P_w = T @ P_prop @ T.T

        HTH = h_x.T @ h_x  # (12,12) — the only N-reductions
        HTh = h_x.T @ h  # (12,)
        valid = out.valid.reshape(())
        if group is not None:
            red = group.all_reduce_sum(torch.cat(
                [HTH.reshape(-1), HTh, valid.to(dtype).reshape(1)]))
            HTH, HTh, valid = red[:144].reshape(12, 12), red[144:156], red[156] > 0

        # info-form gain: P_temp = (P_w/R)^{-1} + blockdiag(HTH, 0)
        P_temp = _spd_solve(P_w / R, eye).clone()
        P_temp[:12, :12] += HTH
        P_inv = _spd_solve(P_temp, eye)
        K_h = P_inv[:, :12] @ HTh  # (23,)
        K_x12 = P_inv[:, :12] @ HTH  # (23, 12)

        dx_ = K_h + K_x12 @ dx_new[:12] - dx_new
        x_new = st.boxplus(x, dx_)
        converged = torch.all(torch.abs(dx_) <= epsi)

        t_new = t + converged.to(i32)
        # force re-search on the second-to-last lap if never converged
        # (esekfom.hpp:1829-1832)
        force = (t_new == 0) & (i == max_iter - 2)
        done_now = (t_new > 1) | (i == max_iter - 1)
        # a pass with no valid point keeps the iterate (JAX's `sel`)
        return (i + 1, torch.where(valid, t_new, t),
                torch.where(valid, converged | force, converge),
                valid & done_now, any_valid | valid, n_evals + 1,
                cf.select(valid, x_new, x),
                torch.where(valid, R * P_inv, P_post),
                torch.where(valid, dx_, dx_final), out.carry)

    # the carry's tensors: x, P_prop and carry0 are read under their own
    # names too, so a gated pass writes copies of them
    x0, P_post0, h_carry0 = cf.own((x, P_prop, carry0))
    carry = (scalar(-1, i32), scalar(0, i32), scalar(True, torch.bool),
             scalar(False, torch.bool), scalar(False, torch.bool),
             scalar(0, i32), x0, P_post0,
             P_prop.new_zeros(n), h_carry0)
    for _ in range(max_iter + 1):
        done = carry[3]
        carry = cf.loop_pass(~done, one_pass, carry)
    _, _, _, _, any_valid, n_evals, x, P_post, dx_final, h_carry = carry

    # Final covariance: (I - K_x) P_w = R * P_inv in exact arithmetic, so
    # P = T (R P_inv) T^T (SPD by construction; see the JAX package's note).
    # P_post is read row-major: the masked passes' pick takes the layout of
    # R * P_inv (column-major, from the triangular solve), a gated pass
    # copies into the carry's own row-major tensor, and a product's
    # rounding on the card follows its operands' layout
    T = _block_transform(dx_final, x, x_prop)
    P_new = torch.where(any_valid, _sym(T @ P_post.contiguous() @ T.T),
                        P_prop)
    return UpdateResult(x=x, P=P_new, carry=h_carry, iterations=n_evals,
                        valid=any_valid)
