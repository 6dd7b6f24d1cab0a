"""Carry a run across from the JAX pipeline: load its state into the port.

``load_numpy_state(pipe, arrays)`` takes the JAX ``Pipeline``'s device state
as numpy arrays (``state_arrays`` below lists the keys) and loads it into a
port ``Pipeline``, which then continues the run the JAX pipeline started.
This is the in-memory handover; the npz checkpoint format
(``utils/checkpoint.py``) is a later item (ROADMAP.md queue A item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from . import state as st
from .imu import ImuCarry
from .map.hash_map import Map

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
    map dtype; nothing aliases the caller's numpy memory.  Raises KeyError on
    a missing key and ValueError on a map of the wrong shape."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing state arrays: {missing}")
    dev, dt = pipe.device, pipe.dtype

    def t(a, dtype=dt):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    packed = np.asarray(arrays["map_packed"])
    if packed.shape != tuple(pipe.map.packed.shape):
        raise ValueError(f"map_packed shape {packed.shape} != the pipeline's "
                         f"{tuple(pipe.map.packed.shape)}")
    pipe.x = st.State(*(t(arrays[f]) for f in STATE_FIELDS))
    pipe.P = t(arrays["P"])
    pipe.map = Map(packed=t(packed, pipe.map.packed.dtype),
                   dropped=t(arrays["map_dropped"], torch.int32))
    pipe.imu_carry = ImuCarry(t(arrays["angvel_last"]), t(arrays["acc_s_last"]))
    pipe.lm_state = (t(arrays["lm_lo"]), t(arrays["lm_hi"]),
                     t(arrays["lm_init"], torch.bool))
    pipe.acc_scale = float(arrays["acc_scale"])
    first = arrays["first_lidar_time"]
    pipe.first_lidar_time = None if first is None else float(first)
    pipe.last_lidar_end_time = float(arrays["last_lidar_end_time"])
    pipe.map_built = bool(arrays["map_built"])
    pipe.imu_need_init = bool(arrays["imu_need_init"])
