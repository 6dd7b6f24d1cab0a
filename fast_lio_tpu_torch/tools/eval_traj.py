"""Trajectory evaluation: ATE / RPE between two TUM-format files.

A copy of the JAX package's ``tools/eval_traj.py`` (it only reads files).
The reference ecosystem evaluates with the external `evo` package; this is
a self-contained equivalent for the runner's outputs
(``trajectory_tum.txt``):

    python3 -m fast_lio_tpu_torch.tools.eval_traj est_tum.txt gt_tum.txt [--align]

TUM format per line: t x y z qx qy qz qw
"""
import argparse
import sys

import numpy as np


def load_tum(path):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]  # t, pos, quat xyzw


def associate(t_a, t_b, max_dt=0.02):
    """Greedy nearest-stamp association."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_align(src, dst, with_scale=False):
    """Least-squares SE(3) (optionally Sim(3)) alignment src -> dst."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    cov = cd.T @ cs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1
    R = U @ W @ Vt
    scale = (np.trace(np.diag(S) @ W) / (cs**2).sum() * len(src)) if with_scale else 1.0
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def ate_rmse(est_p, gt_p, align=False):
    if align:
        s, R, t = umeyama_align(est_p, gt_p)
        est_p = (s * (R @ est_p.T)).T + t
    err = est_p - gt_p
    return float(np.sqrt((err**2).sum(-1).mean())), err


def rpe(est_p, gt_p, delta=10):
    """Relative pose (translation) error over a fixed index delta."""
    n = len(est_p) - delta
    if n <= 0:
        return float("nan")
    d_est = est_p[delta:] - est_p[:-delta]
    d_gt = gt_p[delta:] - gt_p[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--align", action="store_true",
                    help="Umeyama SE(3) alignment before ATE")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--rpe-delta", type=int, default=10)
    args = ap.parse_args(argv)

    t_e, p_e, _ = load_tum(args.est)
    t_g, p_g, _ = load_tum(args.gt)
    ie, ig = associate(t_e, t_g, args.max_dt)
    if len(ie) < 2:
        print("no associations", file=sys.stderr)
        return 1
    ate, err = ate_rmse(p_e[ie], p_g[ig], align=args.align)
    r = rpe(p_e[ie], p_g[ig], args.rpe_delta)
    print(f"pairs: {len(ie)}")
    print(f"ATE RMSE: {ate * 100:.2f} cm  (mean {np.linalg.norm(err, axis=-1).mean() * 100:.2f}, "
          f"max {np.linalg.norm(err, axis=-1).max() * 100:.2f})")
    print(f"RPE RMSE (delta={args.rpe_delta}): {r * 100:.2f} cm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
