"""Wrapper of the hand-written CUDA IMU stage (``csrc/imu.cu``): a scan's
forward propagation over its padded IMU block and the deskew of its points
in two launches, where the plain version (``imu.propagate_and_deskew_plain``)
launches about 1,700 kernels.

Replaces no ``pallas_call``: the JAX package writes the stage in XLA
(``fast_lio_tpu/imu.py``, ``propagate_and_deskew``).  The kernels compute
the plain version's function in its association orders (the quaternion
chain's ``control_flow.associative_scan``, the (F, G) total's
``control_flow.associative_last``) in true f32 or f64, from the pipeline's
float32 feed; their products round
otherwise than cuBLAS's, so they are held to the plain version on the card
by ``tests/test_torch_imu.py``'s tolerances, and give the same bits on
every run.

The custom op ``fast_lio_tpu_torch::propagate_and_deskew``: CPU tensors
take the plain version, CUDA tensors the kernels (built at first use;
anything they do not take raises, and nothing falls back).  Its vmap rule
(the batched step, ``batch.BatchPipeline``) launches each kernel once over
the lane axis on CUDA, an input shared by the lanes (Q, say) broadcast, or
runs the plain version lane by lane on CPU tensors.
``propagate_and_deskew`` (what ``imu.propagate_and_deskew`` calls) takes
the op for CUDA tensors and the plain version itself for CPU ones, so that
a CPU batch runs it under ``torch.func.vmap`` as before.  With
``deskew=False`` (MARSIM) only the propagation kernel runs.

Launch counters, one increment a kernel launch: ``launches`` (float32) and
``launches_f64`` by kernel (``PROPAGATE``, ``DESKEW``), ``batched_launches``
(over a lane axis) by the scalar's bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from .. import imu as imu_plain
from .. import state as st
from . import build

DTYPES = (torch.float32, torch.float64)  # the kernels' computing types
MAX_M = 256  # IMU slots a lane (csrc/imu.cu MAX_M)
PROPAGATE, DESKEW = 0, 1

launches = {PROPAGATE: 0, DESKEW: 0}  # float32
launches_f64 = {PROPAGATE: 0, DESKEW: 0}
batched_launches = {32: 0, 64: 0}

# the op's tensor inputs, in csrc/imu.cu's order: the state's fields, P, Q
# and the carry in the computing type; the feed's in float32; the mask
STATE_FIELDS = st.State._fields
FEED = ("imu_t", "imu_acc", "imu_gyr", "acc_scale", "last_end_rel",
        "pcl_end_rel", "pts", "pt_time")
INPUTS = (*STATE_FIELDS, "P", "Q", "angvel_last", "acc_s_last", *FEED,
          "imu_mask")
KNOT = 17  # scalars a knot (csrc/imu.cu)


def _shapes(M: int, N: int) -> Dict[str, tuple]:
    """Each input's shape, one lane."""
    return dict(pos=(3,), rot=(4,), offset_R_L_I=(4,), offset_T_L_I=(3,),
                vel=(3,), bg=(3,), ba=(3,), grav=(3,), P=(23, 23),
                Q=(12, 12), angvel_last=(3,), acc_s_last=(3,), imu_t=(M,),
                imu_acc=(M, 3), imu_gyr=(M, 3), acc_scale=(),
                last_end_rel=(), pcl_end_rel=(), pts=(N, 3), pt_time=(N,),
                imu_mask=(M,))


def propagate_and_deskew(x: st.State, P, Q, imu_t, imu_acc, imu_gyr,
                         imu_mask, acc_scale, last_end_rel, pcl_end_rel,
                         carry: imu_plain.ImuCarry, pts, pt_time,
                         deskew: bool = True):
    """``imu.propagate_and_deskew_plain``'s (x_end, P_end, pts_out,
    new_carry): on the CPU the plain version itself (under
    ``torch.func.vmap`` too, so a CPU batch rounds as before), else the
    custom op, whose CUDA tensors take the kernels.  With ``deskew`` False
    ``pts_out`` is ``pts``."""
    if _on_cpu(P):
        return imu_plain.propagate_and_deskew_plain(
            x, P, Q, imu_t, imu_acc, imu_gyr, imu_mask, acc_scale,
            last_end_rel, pcl_end_rel, carry, pts, pt_time, deskew=deskew)
    out = torch.ops.fast_lio_tpu_torch.propagate_and_deskew(
        *x, P, Q, *carry, imu_t, imu_acc, imu_gyr, acc_scale, last_end_rel,
        pcl_end_rel, pts, pt_time, imu_mask, deskew)
    x_end = st.State(*out[:8])
    return (x_end, out[8], out[11] if deskew else pts,
            imu_plain.ImuCarry(out[9], out[10]))


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _plain(*args, deskew: bool):
    """The plain version on the op's inputs, as the op's outputs."""
    a = dict(zip(INPUTS, args))
    x = st.State(*(a[f] for f in STATE_FIELDS))
    x_end, P_end, pts_out, carry = imu_plain.propagate_and_deskew_plain(
        x, a["P"], a["Q"], a["imu_t"], a["imu_acc"], a["imu_gyr"],
        a["imu_mask"], a["acc_scale"], a["last_end_rel"], a["pcl_end_rel"],
        imu_plain.ImuCarry(a["angvel_last"], a["acc_s_last"]), a["pts"],
        a["pt_time"], deskew=deskew)
    if not deskew:  # pts itself; an output may not alias an input
        pts_out = a["pts"].new_empty((0, 3), dtype=P_end.dtype)
    return (*x_end, P_end, carry.angvel_last.clone(),
            carry.acc_s_last.clone(), pts_out)


@torch.library.custom_op("fast_lio_tpu_torch::propagate_and_deskew",
                         mutates_args=())
def _op(pos: torch.Tensor, rot: torch.Tensor, offset_R_L_I: torch.Tensor,
        offset_T_L_I: torch.Tensor, vel: torch.Tensor, bg: torch.Tensor,
        ba: torch.Tensor, grav: torch.Tensor, P: torch.Tensor,
        Q: torch.Tensor, angvel_last: torch.Tensor, acc_s_last: torch.Tensor,
        imu_t: torch.Tensor, imu_acc: torch.Tensor, imu_gyr: torch.Tensor,
        acc_scale: torch.Tensor, last_end_rel: torch.Tensor,
        pcl_end_rel: torch.Tensor, pts: torch.Tensor, pt_time: torch.Tensor,
        imu_mask: torch.Tensor, deskew: bool) -> List[torch.Tensor]:
    args = (pos, rot, offset_R_L_I, offset_T_L_I, vel, bg, ba, grav, P, Q,
            angvel_last, acc_s_last, imu_t, imu_acc, imu_gyr, acc_scale,
            last_end_rel, pcl_end_rel, pts, pt_time, imu_mask)
    if _on_cpu(*args):
        return list(_plain(*args, deskew=deskew))
    return list(propagate_and_deskew_cuda(args, deskew))


@_op.register_fake
def _op_fake(*args):
    *tensors, deskew = args
    return list(empty_outputs(tensors, deskew))


def _op_vmap(info, in_dims, *args):
    """Every lane's stage: CUDA, one launch of each kernel over the lane
    axis; CPU, the plain version lane by lane.  An input shared by the
    lanes is broadcast."""
    *tensors, deskew = args
    B = info.batch_size
    lead = [t.movedim(d, 0) if d is not None else t.expand(B, *t.shape)
            for t, d in zip(tensors, in_dims)]
    if _on_cpu(*tensors):
        per = [_plain(*(t[b] for t in lead), deskew=deskew) for b in range(B)]
        out = [torch.stack(o) for o in zip(*per)]
    else:
        out = propagate_and_deskew_cuda(lead, deskew, lanes=B)
    return list(out), [0] * len(out)


torch.library.register_vmap("fast_lio_tpu_torch::propagate_and_deskew",
                            _op_vmap)


def empty_outputs(tensors, deskew: bool, lanes=None) -> Tuple[torch.Tensor, ...]:
    """Uninitialised outputs: the state's fields, P_end, the carry (all of
    P's type) and pts_out ((N, 3), or (0, 3) without ``deskew``), with a
    leading lane axis of ``lanes`` if given, on P's device."""
    a = dict(zip(INPUTS, tensors))
    P = a["P"]
    lead = () if lanes is None else (lanes,)
    N = a["pts"].shape[-2] if deskew else 0
    shapes = [a[f].shape[-1:] for f in STATE_FIELDS] + [
        (23, 23), (3,), (3,), (N, 3)]
    return tuple(torch.empty(lead + tuple(s), dtype=P.dtype, device=P.device)
                 for s in shapes)


def check_inputs(tensors, lanes=None) -> None:
    """Raise ValueError on anything the kernels do not take: the state's
    fields, P, Q and the carry of one type (float32 or float64); the
    feed's eight float32; the mask bool; CUDA tensors on one device; the
    shapes of ``_shapes`` with 2 <= M <= MAX_M (a leading lane axis where
    ``lanes`` is given)."""
    a = dict(zip(INPUTS, tensors))
    P = a["P"]
    lead = () if lanes is None else (lanes,)
    M = a["imu_t"].shape[-1]
    N = a["pts"].shape[-2] if a["pts"].dim() >= 2 else -1
    if P.dtype not in DTYPES:
        raise ValueError(f"P must be float32 or float64 (got {P.dtype})")
    for name, t in a.items():
        want = (torch.bool if name == "imu_mask" else
                torch.float32 if name in FEED else P.dtype)
        if t.dtype != want:
            raise ValueError(f"{name} must be {want} (got {t.dtype})")
    for name, t in a.items():
        if not t.is_cuda or t.device != P.device:
            raise ValueError(f"{name} must be a CUDA tensor on {P.device} "
                             f"(got {t.device})")
    if not 2 <= M <= MAX_M:
        raise ValueError(f"{M} IMU slots: the kernels take 2 to {MAX_M}")
    if lanes is not None and not 1 <= lanes <= 65535:
        raise ValueError(f"{lanes} lanes: the grid's y axis holds 65535")
    for name, shape in _shapes(M, N).items():
        if tuple(a[name].shape) != lead + shape:
            raise ValueError(f"{name} has shape {tuple(a[name].shape)}, "
                             f"not {lead + shape}")
    if N * 3 >= 2**31:
        raise ValueError(f"{N} points: too many for the deskew's grid")


class _Arr(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("lane", ctypes.c_longlong),
                ("row", ctypes.c_longlong)]


class _PropArgs(ctypes.Structure):
    _fields_ = [("inp", _Arr * len(INPUTS)), ("out", ctypes.c_void_p * 11),
                ("knots", ctypes.c_void_p), ("M", ctypes.c_int),
                ("lanes", ctypes.c_int)]


class _DeskewArgs(ctypes.Structure):
    _fields_ = [("knots", ctypes.c_void_p), ("x_end", ctypes.c_void_p * 4),
                ("pts", _Arr), ("pt_time", _Arr), ("out", ctypes.c_void_p),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("lanes", ctypes.c_int)]


@functools.cache
def _lib():
    """The kernels' library, built at first use, with its C signatures."""
    lib = build.load("imu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("f32", "f64"):
        for fn in (getattr(lib, f"imu_propagate_{name}"),
                   getattr(lib, f"imu_deskew_{name}")):
            fn.argtypes = [p, p]
            fn.restype = i
    lib.imu_configure.restype = i
    lib.imu_error_string.argtypes = [i]
    lib.imu_error_string.restype = ctypes.c_char_p
    return lib


_configured = set()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"imu {what} kernel launch failed: "
                           f"{_lib().imu_error_string(err).decode()}")


def _arr(t: torch.Tensor, batched: bool) -> Tuple[_Arr, torch.Tensor]:
    """``t``'s descriptor (a lane's elements one after another along the
    last axis; rows of a matrix ``row`` apart; lanes ``lane`` apart, 0 for
    a broadcast), and the tensor it points into (a contiguous copy where
    the last axis is strided), which must outlive the launch."""
    inner = t.dim() - (1 if batched else 0)
    if inner >= 1 and t.shape[-1] > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    lane = t.stride(0) if batched and t.shape[0] > 1 else 0
    row = t.stride(-2) if inner == 2 else 0
    return _Arr(t.data_ptr(), lane, row), t


def propagate_and_deskew_cuda(tensors, deskew: bool, lanes=None):
    """Launch the propagation (and, with ``deskew``, the deskew) kernel on
    ``torch.cuda.current_stream()`` over ``lanes`` lanes (the tensors with
    a leading lane axis, shared ones expanded) or one (``lanes`` None);
    no sync.  Returns the op's outputs."""
    tensors = list(tensors)
    check_inputs(tensors, lanes)
    a = dict(zip(INPUTS, tensors))
    P = a["P"]
    batched = lanes is not None
    B = lanes if batched else 1
    M = a["imu_t"].shape[-1]
    N = a["pts"].shape[-2]
    out = empty_outputs(tensors, deskew, lanes)
    knots = torch.empty((B, KNOT * M), dtype=P.dtype, device=P.device)
    descs, keep = zip(*(_arr(t, batched) for t in tensors))  # keep: the
    # tensors the descriptors point into, alive until the launches
    prop = _PropArgs((_Arr * len(INPUTS))(*descs),
                     (ctypes.c_void_p * 11)(*(o.data_ptr() for o in out[:11])),
                     knots.data_ptr(), M, B)
    f64 = P.dtype == torch.float64
    tag = "f64" if f64 else "f32"
    lib = _lib()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    with torch.cuda.device(P.device):
        if P.device not in _configured:
            _check(lib.imu_configure(), "configure")
            _configured.add(P.device)
        _check(getattr(lib, f"imu_propagate_{tag}")(ctypes.byref(prop),
                                                    stream), "propagation")
        _count(f64, batched, PROPAGATE)
        if deskew and N > 0:
            des = _DeskewArgs(
                knots.data_ptr(),
                (ctypes.c_void_p * 4)(*(o.data_ptr() for o in out[:4])),
                descs[INPUTS.index("pts")], descs[INPUTS.index("pt_time")],
                out[11].data_ptr(), M, N, B)
            _check(getattr(lib, f"imu_deskew_{tag}")(ctypes.byref(des),
                                                     stream), "deskew")
            _count(f64, batched, DESKEW)
    return out


def _count(f64: bool, batched: bool, kernel: int) -> None:
    if batched:
        batched_launches[64 if f64 else 32] += 1
    else:
        (launches_f64 if f64 else launches)[kernel] += 1
