"""Wrapper of the hand-written CUDA sorted segmented mean
(``csrc/segment_sum.cu``): the voxel downsample's segment sums, counts and
division (``ops/voxel_grid.py``) in one launch.

Replaces no ``pallas_call``: the JAX package sums with XLA's sorted
``jax.ops.segment_sum(..., indices_are_sorted=True)``
(``fast_lio_tpu/ops/voxel_grid.py:108-117``), which adds each segment's
values in sorted order, in sequence.  ``segment_mean_plain`` computes the
same with ``index_add_``, which on the CPU adds in index order too, so it
is bit-equal to JAX's; on CUDA ``index_add_`` adds with atomics, in an order
that changes from run to run, and its last bits can move a convergence test
of the filter by a pass.  The kernel sums each segment in sorted order, as
the plain version does on the CPU, and so gives the same result on every
run, bit for bit the plain version's on the same inputs.

``segment_mean`` is the custom op ``fast_lio_tpu_torch::segment_mean``:
CPU tensors take the plain version, CUDA tensors the kernel (built at
first use; anything it does not take raises, and nothing falls back to
``index_add_``).  Its vmap rule (the batched step, ``batch.BatchPipeline``)
launches the kernel once over the stream axis on CUDA
(``segment_mean_cuda_batched``), or runs the plain version per stream on
the CPU.  ``launches`` counts the single launches by the scalar's bits (32,
64), ``batched_launches`` the launches over a stream axis, one per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

DTYPES = (torch.float32, torch.float64)  # the kernel's instantiations
COLUMNS = (3, 4)  # (x, y, z), and intensity beside them

launches = {32: 0, 64: 0}
batched_launches = {32: 0, 64: 0}


def segment_mean_plain(cols: torch.Tensor, live: torch.Tensor,
                       seg_id: torch.Tensor, n_out: int):
    """(means (n_out, C), out_mask (n_out,)): each segment's sum of ``cols``
    * ``live`` over max(its count, 1), and count > 0.  ``seg_id`` (N,) is
    monotone non-decreasing, dead points in segment ``n_out``, which is
    dropped.  The sums are made from the inputs (``new_zeros``), so that
    under vmap they are batched."""
    w = live.to(cols.dtype)
    sums = cols.new_zeros((n_out + 1, cols.shape[-1]))
    sums.index_add_(0, seg_id, cols * w[:, None])
    cnts = w.new_zeros(n_out + 1)
    cnts.index_add_(0, seg_id, w)
    sums, cnts = sums[:n_out], cnts[:n_out]
    return sums / torch.clamp_min(cnts, 1.0)[:, None], cnts > 0


def segment_mean(cols: torch.Tensor, live: torch.Tensor,
                 seg_id: torch.Tensor, n_out: int):
    """The custom op ``fast_lio_tpu_torch::segment_mean``: on CPU tensors
    ``segment_mean_plain``, on CUDA tensors the kernel."""
    return torch.ops.fast_lio_tpu_torch.segment_mean(cols, live, seg_id,
                                                     n_out)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


@torch.library.custom_op("fast_lio_tpu_torch::segment_mean", mutates_args=())
def _segment_mean_op(cols: torch.Tensor, live: torch.Tensor,
                     seg_id: torch.Tensor, n_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(cols, live, seg_id):
        return segment_mean_plain(cols, live, seg_id, n_out)
    return segment_mean_cuda(cols, live, seg_id, n_out)


@_segment_mean_op.register_fake
def _segment_mean_fake(cols, live, seg_id, n_out):
    return empty_outputs(cols, n_out)


def _segment_mean_vmap(info, in_dims, cols, live, seg_id, n_out):
    """Every stream's segments: CUDA, one launch of the kernel over the
    stream axis; CPU, the plain version per stream.  An input shared by
    the streams is broadcast."""
    S = info.batch_size

    def lead(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)

    cols, live, seg_id = (lead(t, d) for t, d in zip((cols, live, seg_id),
                                                      in_dims[:3]))
    if _on_cpu(cols, live, seg_id):
        per = [segment_mean_plain(cols[s], live[s], seg_id[s], n_out)
               for s in range(S)]
        out = tuple(torch.stack(o) for o in zip(*per))
    else:
        out = segment_mean_cuda_batched(cols.contiguous(), live.contiguous(),
                                        seg_id.contiguous(), n_out)
    return out, (0, 0)


torch.library.register_vmap("fast_lio_tpu_torch::segment_mean",
                            _segment_mean_vmap)


def empty_outputs(cols: torch.Tensor, n_out: int):
    """Uninitialised (means (..., n_out, C) of cols' dtype, out_mask
    (..., n_out) bool) for cols (..., N, C), on its device."""
    lead = cols.shape[:-2]
    return (torch.empty(lead + (n_out, cols.shape[-1]), dtype=cols.dtype,
                        device=cols.device),
            torch.empty(lead + (n_out,), dtype=torch.bool,
                        device=cols.device))


def check_inputs(cols: torch.Tensor, live: torch.Tensor,
                 seg_id: torch.Tensor, n_out: int) -> None:
    """Raise ValueError on anything the kernel does not take: CUDA tensors
    on one device, contiguous, cols (..., N, C) of float32 or float64 with
    C 3 or 4, live (..., N) bool, seg_id (..., N) int64."""
    for name, t in (("cols", cols), ("live", live), ("seg_id", seg_id)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.device != cols.device:
            raise ValueError(f"{name} on {t.device} but cols on "
                             f"{cols.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cols.dtype not in DTYPES:
        raise ValueError(f"cols must be float32 or float64 (got {cols.dtype})")
    if live.dtype != torch.bool or seg_id.dtype != torch.int64:
        raise ValueError(f"live must be bool and seg_id int64 (got "
                         f"{live.dtype}, {seg_id.dtype})")
    if cols.shape[-1] not in COLUMNS:
        raise ValueError(f"cols must have 3 or 4 columns (got "
                         f"{tuple(cols.shape)})")
    if live.shape != cols.shape[:-1] or seg_id.shape != live.shape:
        raise ValueError(f"cols {tuple(cols.shape)}, live "
                         f"{tuple(live.shape)} and seg_id "
                         f"{tuple(seg_id.shape)} disagree")
    if n_out < 0 or (n_out + 1) * cols.shape[-1] >= 2**31 or (
            cols.shape[-2] * cols.shape[-1] >= 2**31):
        raise ValueError(f"n_out {n_out} or N {cols.shape[-2]} out of range")


@functools.cache
def _lib():
    """The kernel's library, built at first use, with its C signatures."""
    lib = build.load("segment_sum")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.segment_mean_f32, lib.segment_mean_f64):
        fn.argtypes = [p, p, p, i, i, i, i, p, p, p]
        fn.restype = i
    lib.segment_mean_error_string.argtypes = [i]
    lib.segment_mean_error_string.restype = ctypes.c_char_p
    return lib


def segment_mean_cuda(cols: torch.Tensor, live: torch.Tensor,
                      seg_id: torch.Tensor, n_out: int):
    """Launch the kernel on ``torch.cuda.current_stream()``; no sync."""
    if cols.dim() != 2:
        raise ValueError(f"cols must be (N, C) (got {tuple(cols.shape)})")
    check_inputs(cols, live, seg_id, n_out)
    out = empty_outputs(cols, n_out)
    if _launch(cols, live, seg_id, n_out, 1, out):
        launches[8 * cols.element_size()] += 1
    return out


def segment_mean_cuda_batched(cols: torch.Tensor, live: torch.Tensor,
                              seg_id: torch.Tensor, n_out: int):
    """One launch over a stream axis: cols (S, N, C), live and seg_id
    (S, N), contiguous.  Returns (means (S, n_out, C), out_mask (S, n_out)),
    stream s's what ``segment_mean_cuda(cols[s], live[s], seg_id[s],
    n_out)`` returns.  On ``torch.cuda.current_stream()``; no sync."""
    if cols.dim() != 3:
        raise ValueError(f"cols must be (S, N, C) (got {tuple(cols.shape)})")
    check_inputs(cols, live, seg_id, n_out)
    out = empty_outputs(cols, n_out)
    if _launch(cols, live, seg_id, n_out, cols.shape[0], out):
        batched_launches[8 * cols.element_size()] += 1
    return out


def _launch(cols, live, seg_id, n_out: int, streams: int, out) -> bool:
    """The kernel over ``streams`` lanes into ``out`` = (means, out_mask).
    Returns whether it launched (not for no segment or no stream)."""
    if n_out == 0 or streams == 0:
        return False
    if streams > 65535:
        raise ValueError(f"{streams} streams: the grid's y axis holds 65535")
    lib = _lib()
    fn = (lib.segment_mean_f64 if cols.dtype == torch.float64
          else lib.segment_mean_f32)
    means, mask = out
    with torch.cuda.device(cols.device):
        err = fn(cols.data_ptr(), live.data_ptr(), seg_id.data_ptr(),
                 cols.shape[-2], cols.shape[-1], n_out, streams,
                 means.data_ptr(), mask.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("segment_mean kernel launch failed: "
                           f"{lib.segment_mean_error_string(err).decode()}")
    return True
