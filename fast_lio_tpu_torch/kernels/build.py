"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/fast_lio_tpu_torch/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source and the
flags (and the shared headers, ``csrc/*.cuh``), so an edited source is
rebuilt and an unchanged one is reused.

Nothing here runs at import time: ``load`` builds on the first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from .. import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fast_lio_tpu_torch"

# every source of the step's kernels in csrc/; probe.cu (tools/probe.py) and
# stamp.cu (the tracer's) are built at their first use
LIBS = ("knn", "knn_grouped", "graph_if", "segment_sum")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills into the build log
)

def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, every header in ``csrc/``
    and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source not yet built, one nvcc per source, all
    started together (each adds one to ``tracing.counters["kernel_builds"]``).
    Raises with the compiler's output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
        tracing.counters["kernel_builds"] += 1
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Registers, spilled bytes and static shared memory of each kernel in
    an ``nvcc -Xptxas -v`` log, by its (mangled) entry name."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            usage[entry]["smem_bytes"] = int(m[1])
    return usage


def kernel_usage(name: str) -> Dict[str, dict]:
    """``ptxas_usage`` of the built ``csrc/<name>.cu``."""
    return ptxas_usage(library_path(name).with_suffix(".log").read_text())


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it if needed (the
    caller keeps the handle): a ``build`` span, whose ``compiled`` says
    whether ``nvcc`` ran."""
    with tracing.span("build", lib=name,
                      compiled=not library_path(name).exists()):
        return ctypes.CDLL(str(build_all([name])[name]))
