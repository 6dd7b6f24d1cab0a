"""Microbenchmark of the IMU stage's two kernels on the card (the
propagation and the deskew, ``kernels/imu.py``, ``csrc/imu.cu``) against
the plain version (``imu.propagate_and_deskew_plain``), on the inputs of
the first steps of each path ``chip_smoke.py`` runs: every IMU block size
M, point pad N, computing type (the feed is float32 on every path) and
lane count that a path gives the stage.

Run from the repository root on a machine with a CUDA device:

    python3 -m fast_lio_tpu_torch.tools.microbench_imu

``chip_smoke.py`` phase 2 runs ``rows`` too.  Each path's inputs
(``recorded``) are those its eager pipeline hands the stage on the first
``LANES`` steps that propagate, on a short sim run of the path's own
sensor and configuration (``path_run``); the batched cases stack those
steps as lanes, Q shared.  ``inputs`` makes synthetic blocks for
``tests/test_torch_imu_kernel.py``: a rotating, accelerating platform,
about a third of the slots real at 200 Hz, garbage in the padded slots.

For each case: ``propagate_us`` (a CUDA graph of 100 calls with
``deskew=False``, per call: the propagation kernel alone), ``both_us``
(the same with the deskew), ``deskew_us`` (their difference; None where
the path runs no deskew, MARSIM), ``plain_us`` (the plain version in a
CUDA graph of 10 calls, per call), each kernel's bound
(``kernels/bounds.imu_propagate_bound``, ``imu_deskew_bound``) and the
largest difference of each output from the plain version's
(``max_abs_err``; P relative to its largest entry), held to
``tests/test_torch_imu.py``'s tolerances.  Prints one JSON line per case,
then the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import imu as timu
from .. import state as tst
from ..filter import process as tproc
from ..kernels import bounds

LANES = 4
REPS = 100
RECORD_S = 1.0  # seconds of each path's sim run (ten 0.1-s scans)
# chip_smoke.py's paths by the shape of the stage they run (M, N, deskew):
# avia (64, 32768), ouster64 (64, 45056), oracle (32, 8192), bench_ouster64
# (32, 45056: bench.py's scenario), mid360 (8, 1024: bench.py's 100-Hz
# scenario, and the sharded dry run's shape), validation (32, 2048),
# prune_hall (32, 8192, float64), marsim (64, 32768, no deskew)
PATHS = ("avia", "ouster64", "oracle", "bench_ouster64", "mid360",
         "validation", "prune_hall", "marsim")
# row -> (computing type, lanes, the paths it is held and timed on; the
# first gives the row's figures, the others stand in it by name)
KINDS = {"imu": (torch.float32, 1, ("avia", "ouster64", "oracle",
                                    "bench_ouster64", "mid360",
                                    "validation", "marsim")),
         "imu_f64": (torch.float64, 1, ("ouster64", "oracle", "prune_hall")),
         "imu_batched": (torch.float32, LANES, ("avia",)),
         "imu_batched_f64": (torch.float64, LANES, ("ouster64",))}
# tests/test_torch_imu.py's: (state, carry and points; P relative)
TOLS = {torch.float32: (1e-6, 2e-5), torch.float64: (1e-10, 1e-10)}
BLOCKS = ("padded", "stale_prefix", "no_valid", "no_deskew")


def path_run(name: str):
    """(configuration, sim run of ``RECORD_S`` seconds) of path ``name``:
    its configuration and its sensor's sim, as ``chip_smoke.py`` runs it."""
    from .. import sim
    from . import oracle_compare, profile_scan, scenarios
    if name in ("avia", "ouster64"):
        cfg, sim_cfg = profile_scan.RUNS[name]
        return cfg, sim.generate(dataclasses.replace(sim_cfg,
                                                     duration=RECORD_S))
    if name == "oracle":
        return (oracle_compare.make_cfg(),
                oracle_compare.make_data(int(RECORD_S * 10)))
    if name == "bench_ouster64":
        return scenarios.scenario("ouster64", RECORD_S)
    if name == "mid360":  # 0.01-s scans
        return scenarios.scenario("mid360", RECORD_S / 10)
    if name == "validation":
        return scenarios.validation_config(), sim.generate(sim.SimConfig(
            duration=RECORD_S, n_rings=8, n_azimuth=150))
    if name == "prune_hall":
        return scenarios.prune_run(duration=RECORD_S)
    if name == "marsim":
        cfg, _, data = scenarios.preset_run("marsim", RECORD_S)
        return cfg, data
    raise ValueError(f"unknown path {name!r}: one of {', '.join(PATHS)}")


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        vals = [_clone(v) for v in a]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return a


def recorded(path: str, dtype: torch.dtype, calls: int = LANES,
             device: str = "cuda") -> Tuple[List[tuple], bool]:
    """(the args of the first ``calls`` calls of
    ``imu.propagate_and_deskew`` that path ``path``'s eager pipeline makes
    in ``dtype``, its ``deskew``)."""
    from .. import pipeline
    from . import bench_scaling
    cfg, data = path_run(path)
    cfg = dataclasses.replace(cfg, compute_dtype=str(dtype).split(".")[-1])
    kept, flags = [], []
    stage = timu.propagate_and_deskew

    def keep(*args, deskew=True):
        if len(kept) < calls:
            kept.append(_clone(args))
            flags.append(deskew)
        return stage(*args, deskew=deskew)

    pipe = pipeline.Pipeline(cfg, device=device, graphs=False)
    timu.propagate_and_deskew = keep
    try:
        for _ in bench_scaling.run_scans(pipe, data, len(data.scan_stamps)):
            if len(kept) == calls:
                break
    finally:
        timu.propagate_and_deskew = stage
    if len(kept) < calls or len(set(flags)) != 1:
        raise RuntimeError(f"{path}: {len(kept)} IMU stages recorded "
                           f"({flags}), not {calls} of one kind")
    return kept, flags[0]


def n_valid(args) -> int:
    """Valid pairs of one lane's block (imu.py's pair mask)."""
    imu_t, mask, last_end = args[3], args[6], args[8]
    return int((mask[1:] & (imu_t[1:] >= last_end)).sum())


def inputs(block: str, M: int, N: int, dtype, feed, seed: int,
           device="cuda"):
    """(args, deskew) of ``propagate_and_deskew`` for one padded IMU block
    of M slots (about a third real, at 200 Hz; ``block`` one of
    ``BLOCKS``: a stale prefix, no valid pair, or no deskew) and N points:
    a rotating, accelerating platform, garbage in the padded slots.  The
    block is one (M, 7) array of the feed's type, acc and gyr strided views
    of it, as the pipeline's feed gives them."""
    rng = np.random.default_rng(seed)
    n = max(3, min(M, M // 3 + 2))
    stale = block == "stale_prefix"
    t = np.linspace(-0.02 if stale else 0.0, 0.1, n)
    last_end = 0.0 if stale else -0.005
    if block == "no_valid":
        last_end = 1.0  # every tail before the previous scan's end
    imu = np.zeros((M, 7))
    imu[:, 0] = t[-1]
    imu[:n, 0] = t
    imu[:n, 1:4] = np.array([0.4, -0.2, 9.809]) + rng.normal(0, 0.05, (n, 3))
    imu[:n, 4:7] = np.array([0.3, -0.5, 1.2]) + rng.normal(0, 0.01, (n, 3))
    imu[n:, 1:4], imu[n:, 4:7] = 777.0, -555.0
    dx = rng.normal(size=23) * 0.2
    dx[0:3] *= 50.0
    dx[21:23] = 0.0
    x = tst.boxplus(tst.identity_state(torch.float64), torch.from_numpy(dx))
    g = np.array([0.1, 0.2, -1.0])
    x = x._replace(grav=torch.from_numpy(g / np.linalg.norm(g) *
                                         tst.S2_LENGTH))
    A = rng.normal(size=(23, 23)) * 1e-2
    P = np.eye(23) * 1e-3 + A @ A.T
    pts = rng.normal(size=(N, 3)) * 10.0
    ptt = np.sort(rng.uniform(0.0, 0.1, N))

    def tt(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    block_t = tt(imu, feed)
    args = (tst.State(*(v.to(dtype=dtype, device=device) for v in x)),
            tt(P, dtype),
            tproc.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, dtype, device),
            block_t[:, 0].contiguous(), block_t[:, 1:4], block_t[:, 4:7],
            tt(np.arange(M) < n, torch.bool), tt(1.01, feed),
            tt(last_end, feed), tt(0.1, feed),
            timu.ImuCarry(tt(rng.normal(size=3) * 0.1, dtype),
                          tt(rng.normal(size=3) * 0.1, dtype)),
            tt(pts, feed), tt(ptt, feed))
    return args, block != "no_deskew"


def flat(out) -> list:
    """``propagate_and_deskew``'s results as one list: the state's fields,
    P, the points, the carry."""
    x, P, pts, carry = out
    return [*x, P, pts, *carry]


def stack(lanes) -> tuple:
    """The lanes' args stacked on a leading axis, Q shared (``vmapped``
    maps it with None)."""
    def st(vals):
        if isinstance(vals[0], tuple):
            return type(vals[0])(*(st([v[i] for v in vals])
                                   for i in range(len(vals[0]))))
        return torch.stack(vals)
    args = [st([lane[i] for lane in lanes]) for i in range(len(lanes[0]))]
    args[2] = lanes[0][2]
    return tuple(args)


def vmapped(fn, args, deskew: bool) -> list:
    """``flat(fn(...))`` under ``torch.func.vmap`` over ``stack``'s lanes."""
    dims = tuple(None if i == 2 else 0 for i in range(len(args)))
    return torch.func.vmap(lambda *a: flat(fn(*a, deskew=deskew)),
                           in_dims=dims)(*args)


def max_errors(got, want) -> Dict[str, float]:
    """The largest |difference| of each output group (P relative to its
    largest entry)."""
    names = [*tst.State._fields, "P", "pts", "angvel_last", "acc_s_last"]
    out = {"state": 0.0, "carry": 0.0}
    for name, g, w in zip(names, got, want):
        d = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
        if name == "P":
            out["P_rel"] = d / float(w.double().abs().max())
        elif name == "pts":
            out["pts"] = d
        else:
            key = "carry" if name in ("angvel_last", "acc_s_last") else "state"
            out[key] = max(out[key], d)
    return out


def within_tolerance(errors: Dict[str, float], dtype) -> bool:
    """Whether ``max_errors`` fit the tolerances of
    ``tests/test_torch_imu.py`` (their absolute parts)."""
    tol, ptol = TOLS[dtype]
    return (errors["state"] <= tol and errors["carry"] <= tol
            and errors["pts"] <= 10 * tol and errors["P_rel"] <= ptol)


def graph_us(fn, reps: int = REPS) -> float:
    """Per call, a CUDA graph of ``reps`` calls of ``fn``: the least of 5
    replays, by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the warm-up, off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, 1e3 * e0.elapsed_time(e1) / reps)
    return best


def measure(kind: str, path: str, kept: List[tuple], deskew: bool) -> dict:
    """The case's row: shape, times, bounds and max |delta| against the
    plain version, on path ``path``'s recorded inputs ``kept`` (one a
    lane) and ``deskew``."""
    dtype, lanes, _ = KINDS[kind]
    if lanes == 1:
        args = kept[0]

        def call(fn, deskew):
            return flat(fn(*args, deskew=deskew))
    else:
        args = stack(kept[:lanes])

        def call(fn, deskew):
            return vmapped(fn, args, deskew)
    kernel, plain = timu.propagate_and_deskew, timu.propagate_and_deskew_plain
    got, want = call(kernel, deskew), call(plain, deskew)
    again = call(kernel, deskew)
    torch.cuda.synchronize()
    errors = max_errors(got, want)
    valid = [n_valid(a) for a in kept[:lanes]]
    M, N = args[3].shape[-1], args[11].shape[-2]
    prop = graph_us(lambda: call(kernel, False))
    both = graph_us(lambda: call(kernel, True)) if deskew else None
    return dict(
        case=f"{kind}_{path}", kind=kind, path=path,
        shape=dict(M=M, N=N, lanes=lanes, valid_pairs=valid,
                   dtype=str(dtype), deskew=deskew),
        propagate_us=prop, both_us=both,
        deskew_us=both - prop if deskew else None,
        plain_us=graph_us(lambda: call(plain, deskew), reps=10),
        propagate_bound_us=sum(1e3 * bounds.imu_propagate_bound(
            v, dtype).ms for v in valid),
        deskew_bound_us=(1e3 * bounds.imu_deskew_bound(N, M, dtype, lanes).ms
                         if deskew else 0.0),
        max_abs_err=errors, within_tolerance=within_tolerance(errors, dtype),
        run_to_run_equal=all(torch.equal(g, a) for g, a in zip(got, again)))


def rows() -> Dict[str, dict]:
    """Every case's row, by name (``<kind>_<path>``), each kind's paths in
    ``KINDS``' order."""
    out, inputs = {}, {}
    for kind, (dtype, _, paths) in KINDS.items():
        for path in paths:
            if (path, dtype) not in inputs:
                inputs[path, dtype] = recorded(path, dtype)
            row = measure(kind, path, *inputs[path, dtype])
            out[row["case"]] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_imu: no CUDA device; nothing run")
        return 1
    for row in rows().values():
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
