"""Carry a run across from the JAX pipeline: load its state into the port.

``load_numpy_state(pipe, arrays)`` takes the JAX ``Pipeline``'s device state
as numpy arrays (``state_arrays`` below lists the keys) and loads it into a
port ``Pipeline``, which then continues the run the JAX pipeline started.
``load_numpy_batch_state(bp, arrays)`` does the same for a JAX
``BatchPipeline``'s stacked state and a port ``BatchPipeline``: the same
keys, every device array with a leading stream axis of B and every host
scalar a sequence of B values.  This is the in-memory handover of the
device state only; the npz
checkpoint (``utils/checkpoint.py``: ``save_pipeline``/``load_pipeline``)
also carries the sync statistics and IMU init stats, and is the way to
resume a run written to disk by either package.
"""
from __future__ import annotations

import numpy as np
import torch

from . import state as st
from .imu import ImuCarry
from .map import hash_map as hm
from .utils.checkpoint import local_map

STATE_FIELDS = st.State._fields
HOST_SCALARS = ("acc_scale", "first_lidar_time", "last_lidar_end_time",
                "map_built", "imu_need_init")
DEVICE_ARRAYS = STATE_FIELDS + ("P", "map_packed", "map_dropped",
                                "angvel_last", "acc_s_last",
                                "lm_lo", "lm_hi", "lm_init")
KEYS = DEVICE_ARRAYS + HOST_SCALARS


def load_numpy_state(pipe, arrays: dict) -> None:
    """Load ``arrays`` (every key of ``KEYS``) into ``pipe`` in place.

    Float arrays are copied in the pipeline's compute dtype, the map in its
    map dtype, into the pipeline's own tensors (``Pipeline.load_state``);
    nothing aliases the caller's numpy memory.  A sharded
    pipeline takes a sharded JAX pipeline's global layout (``map_packed``
    (n * H_local, 4B), ``map_dropped`` (n,)) and keeps its rank's rows.
    Raises KeyError on a missing key and ValueError on a map of the wrong
    shape or layout."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing state arrays: {missing}")
    dev, dt = pipe.device, pipe.dtype

    def t(a, dtype=dt):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    m = local_map(pipe, np.asarray(arrays["map_packed"]),
                  np.asarray(arrays["map_dropped"]))
    pipe.load_state(
        x=st.State(*(t(arrays[f]) for f in STATE_FIELDS)), P=t(arrays["P"]),
        map=m, imu_carry=ImuCarry(t(arrays["angvel_last"]),
                                  t(arrays["acc_s_last"])),
        lm_state=(t(arrays["lm_lo"]), t(arrays["lm_hi"]),
                  t(arrays["lm_init"], torch.bool)))
    pipe.acc_scale = float(arrays["acc_scale"])
    first = arrays["first_lidar_time"]
    pipe.first_lidar_time = None if first is None else float(first)
    pipe.last_lidar_end_time = float(arrays["last_lidar_end_time"])
    pipe.map_built = bool(arrays["map_built"])
    pipe.imu_need_init = bool(arrays["imu_need_init"])


def load_numpy_batch_state(bp, arrays: dict) -> None:
    """Load ``arrays`` (every key of ``KEYS``, stacked over the B streams)
    into the port ``BatchPipeline`` ``bp`` in place: float arrays in its
    compute dtype, the map (``map_packed`` (B, H, 4B), ``map_dropped``
    (B,)) into each lane's rows (``BatchPipeline.load_state``), the host
    scalars per stream.  Raises KeyError on a missing key and ValueError on
    a shape that differs."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing state arrays: {missing}")
    dev, dt = bp.device, bp.dtype

    def t(a, dtype=dt):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    for k in HOST_SCALARS:
        if len(arrays[k]) != bp.B:
            raise ValueError(f"{k}: {len(arrays[k])} values for {bp.B} "
                             "streams")
    bp.load_state(
        x=st.State(*(t(arrays[f]) for f in STATE_FIELDS)), P=t(arrays["P"]),
        map=hm.Map(packed=t(arrays["map_packed"]),
                   dropped=t(arrays["map_dropped"], torch.int32)),
        imu_carry=ImuCarry(t(arrays["angvel_last"]),
                           t(arrays["acc_s_last"])),
        lm_state=(t(arrays["lm_lo"]), t(arrays["lm_hi"]),
                  t(arrays["lm_init"], torch.bool)))
    for i in range(bp.B):
        bp.acc_scale[i] = float(arrays["acc_scale"][i])
        first = arrays["first_lidar_time"][i]
        bp.first_lidar_time[i] = None if first is None else float(first)
        bp.last_lidar_end_time[i] = float(arrays["last_lidar_end_time"][i])
        bp.map_built[i] = bool(arrays["map_built"][i])
        bp.imu_need_init[i] = bool(arrays["imu_need_init"][i])
