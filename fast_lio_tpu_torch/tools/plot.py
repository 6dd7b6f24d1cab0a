"""Offline analysis plots — the Log/plot.py + fast_lio_time_log_analysis.m
analog (the reference's Log/plot.py:7-32, 8-panel state evolution;
Log/fast_lio_time_log_analysis.m:12-31, timing analysis).

A copy of the JAX package's ``tools/plot.py``: it reads the runner's output
files (``pos_log.txt``, ``fast_lio_time_log.csv``), which the port writes
byte for byte as the JAX package does, and imports matplotlib only when it
draws.

Usage:
    python3 -m fast_lio_tpu_torch.tools.plot --out out/   # reads out/pos_log.txt etc.
    python3 -m fast_lio_tpu_torch.tools.plot --timing out/fast_lio_time_log.csv
"""
import argparse
import sys
from pathlib import Path

import numpy as np


def load_pos_log(path):
    """pos_log.txt columns (dump_lio_state_to_log, laserMapping.cpp:150-164):
    t, rot(3), pos(3), omega(3), vel(3), acc(3), bg(3), ba(3), grav(3)."""
    data = np.loadtxt(path)
    return {
        "t": data[:, 0],
        "rot": data[:, 1:4],
        "pos": data[:, 4:7],
        "vel": data[:, 10:13],
        "bg": data[:, 16:19],
        "ba": data[:, 19:22],
        "grav": data[:, 22:25],
    }


def plot_states(log, save_to=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 2, figsize=(12, 9))
    panels = [
        ("rot", "attitude (rad)"),
        ("pos", "position (m)"),
        ("vel", "velocity (m/s)"),
        ("bg", "gyro bias (rad/s)"),
        ("ba", "acc bias (m/s^2)"),
        ("grav", "gravity (m/s^2)"),
    ]
    for ax, (key, title) in zip(axes.flat, panels):
        for i, lbl in enumerate("xyz"):
            ax.plot(log["t"], log[key][:, i], label=lbl, lw=0.9)
        ax.set_title(title)
        ax.grid(alpha=0.3)
        ax.legend(fontsize=7)
    fig.tight_layout()
    out = save_to or "state_evolution.png"
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")


def plot_timing(csv_path, save_to=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # the CSV may open with a '#' comment line (stage-column semantics:
    # search/incremental/delete are run-level slope constants, flat across
    # rows; n_eff is per-frame).  genfromtxt would mistake a leading '#'
    # line for the names row, so skip it explicitly.
    with open(csv_path) as f:
        skip = 1 if f.readline().startswith("#") else 0
    rows = np.genfromtxt(csv_path, delimiter=",", names=True,
                         skip_header=skip)
    t = rows["time_stamp"] - rows["time_stamp"][0]
    fig, axes = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
    axes[0].plot(t, rows["total_time"] * 1e3, lw=0.8, label="total")
    axes[0].set_ylabel("per-scan time (ms)")
    axes[0].legend()
    axes[0].grid(alpha=0.3)
    axes[1].plot(t, rows["tree_size_end"], lw=0.8, label="map size")
    axes[1].plot(t, rows["add_point_size"], lw=0.8, label="downsampled pts")
    if "n_eff" in (rows.dtype.names or ()):
        axes[1].plot(t, rows["n_eff"], lw=0.8, label="effective pts")
    axes[1].set_xlabel("time (s)")
    axes[1].legend()
    axes[1].grid(alpha=0.3)
    fig.tight_layout()
    out = save_to or "timing.png"
    fig.savefig(out, dpi=130)
    mean_ms = float(np.mean(rows["total_time"])) * 1e3
    print(f"wrote {out}; mean per-scan {mean_ms:.2f} ms "
          f"({1000.0 / max(mean_ms, 1e-9):.1f} Hz)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="pipeline output dir (reads pos_log/csv)")
    ap.add_argument("--pos-log")
    ap.add_argument("--timing")
    args = ap.parse_args(argv)
    did = False
    if args.out:
        d = Path(args.out)
        if (d / "pos_log.txt").exists():
            plot_states(load_pos_log(d / "pos_log.txt"), d / "state_evolution.png")
            did = True
        if (d / "fast_lio_time_log.csv").exists():
            plot_timing(d / "fast_lio_time_log.csv", d / "timing.png")
            did = True
    if args.pos_log:
        plot_states(load_pos_log(args.pos_log))
        did = True
    if args.timing:
        plot_timing(args.timing)
        did = True
    if not did:
        print("nothing to plot", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
