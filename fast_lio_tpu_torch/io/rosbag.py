"""Pure-Python ROS1 bag (v2.0) reader — no ROS installation required.

The reference consumes live ROS topics (laserMapping.cpp:845-848) and its
canonical datasets are rosbags (README.md:236-261).  This module replays
those bags straight into the pipeline: it parses the bag container format,
decompresses chunks (none/bz2; lz4 if the lz4 package exists), and
deserializes the three message types FAST-LIO consumes:

  * sensor_msgs/Imu
  * sensor_msgs/PointCloud2  (Velodyne / Ouster / generic XYZI layouts)
  * livox_ros_driver/CustomMsg AND livox_ros_driver2/CustomMsg — post-2022
    Avia/MID-360 recordings use driver2, whose CustomMsg/CustomPoint field
    layout is wire-identical (header, u64 timebase, u32 point_num,
    u8 lidar_id, u8[3] rsvd, then {u32 offset_time, 3xf32 xyz,
    u8 reflectivity/tag/line} records); only the type string differs, so
    both map to the same parser.

Deserialized messages come out as dicts of numpy arrays matching what
fast_lio_tpu_torch.preprocess.drivers.decode expects.  Port of
``fast_lio_tpu/io/rosbag.py`` (numpy only): the same reader, parsers,
writer and serialisers, so bags written by either package read in the
other; ``replay_into_pipeline`` feeds a port ``Pipeline``.  Unreadable input (wrong
magic, ROS2 bags, truncated/corrupt records, no matching topics) raises
the named ``BagFormatError`` with an actionable message.
"""
from __future__ import annotations

import bz2
import struct
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..preprocess.drivers import decode

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07


class BagFormatError(ValueError):
    """A bag that is not a readable ROS1 v2.0 bag: wrong magic, truncated
    mid-record (interrupted recording / partial download), or garbage where
    a record header should be.  Named so day-one runs on real datasets fail
    with an actionable message instead of a raw struct.error."""


def _parse_fields(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        if i + 4 > len(buf):
            raise BagFormatError("truncated record header fields")
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        if i + flen > len(buf):
            raise BagFormatError("truncated record header fields")
        field = buf[i : i + flen]
        i += flen
        eq = field.find(b"=")
        if eq < 0:
            raise BagFormatError("malformed record header field (no '=')")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


def _read_record(buf: bytes, pos: int) -> Tuple[Dict[str, bytes], bytes, int]:
    if pos + 4 > len(buf):
        raise BagFormatError(f"truncated record at offset {pos}")
    (hlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if pos + hlen + 4 > len(buf):
        raise BagFormatError(f"truncated record header at offset {pos - 4}")
    header = _parse_fields(buf[pos : pos + hlen])
    pos += hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if pos + dlen > len(buf):
        raise BagFormatError(
            f"truncated record data at offset {pos - 4} "
            f"(need {dlen} bytes, {len(buf) - pos} left — interrupted "
            "recording or partial download?)")
    data = buf[pos : pos + dlen]
    pos += dlen
    return header, data, pos


# ---------------------------------------------------------------------------
# message deserializers (ROS1 wire format)
# ---------------------------------------------------------------------------


def _read_string(buf: bytes, i: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4 : i + 4 + n].decode(errors="replace"), i + 4 + n


def _read_header(buf: bytes, i: int) -> Tuple[float, int]:
    # std_msgs/Header: uint32 seq, time stamp (2 x uint32), string frame_id
    _seq, secs, nsecs = struct.unpack_from("<III", buf, i)
    i += 12
    _frame, i = _read_string(buf, i)
    return secs + nsecs * 1e-9, i


def parse_imu(data: bytes) -> dict:
    t, i = _read_header(data, 0)
    vals = struct.unpack_from("<4d9d3d9d3d9d", data, i)
    return {
        "stamp": t,
        "orientation": np.array(vals[0:4]),
        "angular_velocity": np.array(vals[13:16]),
        "linear_acceleration": np.array(vals[25:28]),
    }


_PC2_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def parse_pointcloud2(data: bytes) -> dict:
    t, i = _read_header(data, 0)
    height, width = struct.unpack_from("<II", data, i)
    i += 8
    (nfields,) = struct.unpack_from("<I", data, i)
    i += 4
    fields = []
    for _ in range(nfields):
        name, i = _read_string(data, i)
        off, dt, cnt = struct.unpack_from("<IBI", data, i)
        i += 9
        fields.append((name, off, dt, cnt))
    is_bigendian, point_step, row_step = struct.unpack_from("<BII", data, i)
    i += 9
    (dlen,) = struct.unpack_from("<I", data, i)
    i += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=i)
    i += dlen
    n = (height * width) if height * width > 0 else dlen // point_step
    raw = raw[: n * point_step].reshape(n, point_step)

    out = {"stamp": t, "n": n}
    for name, off, dt, cnt in fields:
        npdt = _PC2_DTYPES[dt]
        w = np.dtype(npdt).itemsize
        col = (
            raw[:, off : off + w * cnt]
            .copy()
            .view(npdt)
            .reshape(n, cnt)
        )
        out[name] = col[:, 0] if cnt == 1 else col
    xyz = np.stack(
        [out.get("x", np.zeros(n)), out.get("y", np.zeros(n)),
         out.get("z", np.zeros(n))], axis=-1
    ).astype(np.float64)
    out["xyz"] = xyz
    if "intensity" not in out:
        out["intensity"] = np.zeros(n, np.float32)
    return out


def parse_livox_custommsg(data: bytes) -> dict:
    t, i = _read_header(data, 0)
    timebase, point_num, _lidar_id = struct.unpack_from("<QIB", data, i)
    i += 13 + 3  # + rsvd[3]
    rec = np.dtype(
        [
            ("offset_time", "<u4"),
            ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
            ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"),
        ]
    )
    (arr_len,) = struct.unpack_from("<I", data, i)
    i += 4
    pts = np.frombuffer(data, rec, count=arr_len, offset=i)
    return {
        "stamp": t,
        "timebase": timebase,
        "xyz": np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float64),
        "reflectivity": pts["reflectivity"].astype(np.float32),
        "offset_time_ns": pts["offset_time"].astype(np.int64),
        "tag": pts["tag"],
        "line": pts["line"],
    }


_PARSERS = {
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "livox_ros_driver/CustomMsg": parse_livox_custommsg,
    "livox_ros_driver2/CustomMsg": parse_livox_custommsg,
}


class BagReader:
    """Iterates (topic, type, stamp, parsed_msg) in chunk order.

    The bag is memory-MAPPED, not loaded: resident memory stays bounded by
    the OS page cache plus one decompressed chunk (multi-GB NCLT bags replay
    in bounded memory)."""

    def __init__(self, path):
        import mmap

        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._buf = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:  # zero-length file cannot be mapped
            self._file.close()
            raise BagFormatError(f"{path}: empty file, not a ROS bag") from e
        if self._buf[:13] != b"#ROSBAG V2.0\n":
            head = bytes(self._buf[:13])
            self.close()
            raise BagFormatError(
                f"{path}: not a ROS1 bag v2.0 (magic {head!r}; ROS2 bags "
                "are sqlite3/mcap and need conversion, e.g. `rosbags`)")
        self._connections: Dict[int, Tuple[str, str]] = {}

    def close(self):
        self._buf.close()
        self._file.close()

    @property
    def connections(self) -> Dict[str, str]:
        """{topic: msg type} of every connection seen so far (fully
        populated after one pass of messages())."""
        return {t: m for t, m in self._connections.values()}

    def messages(
        self, topics: Optional[set] = None
    ) -> Iterator[Tuple[str, str, float, dict]]:
        buf = self._buf
        pos = buf.find(b"\n") + 1
        while pos < len(buf):
            header, data, pos = _read_record(buf, pos)
            op = header.get("op", b"\x00")[0]
            if op == _OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    try:
                        import lz4.frame  # optional

                        data = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise RuntimeError(
                            "bag uses lz4 chunks; lz4 package unavailable"
                        ) from e
                yield from self._iter_chunk(data, topics)
            elif op == _OP_CONNECTION:
                self._register_connection(header, data)

    def _register_connection(self, header, data):
        conn = struct.unpack("<I", header["conn"])[0] if isinstance(
            header.get("conn"), bytes
        ) else 0
        fields = _parse_fields(data)
        topic = header.get("topic", b"").decode()
        mtype = fields.get("type", b"").decode()
        self._connections[conn] = (topic, mtype)

    def _iter_chunk(self, data: bytes, topics):
        pos = 0
        while pos < len(data):
            header, rec, pos = _read_record(data, pos)
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._register_connection(header, rec)
            elif op == _OP_MSG:
                (conn,) = struct.unpack("<I", header["conn"])
                secs, nsecs = struct.unpack("<II", header["time"])
                stamp = secs + nsecs * 1e-9
                topic, mtype = self._connections.get(conn, ("?", "?"))
                if topics is not None and topic not in topics:
                    continue
                parser = _PARSERS.get(mtype)
                if parser is None:
                    continue
                try:
                    yield topic, mtype, stamp, parser(rec)
                except (struct.error, IndexError) as e:
                    raise BagFormatError(
                        f"{self.path}: corrupt {mtype} message on "
                        f"{topic!r} at t={stamp:.3f}: {e}") from e


# ---------------------------------------------------------------------------
# minimal writer (uncompressed, single chunk) — enough for tests/recording
# ---------------------------------------------------------------------------


def _field(name: str, value: bytes) -> bytes:
    f = name.encode() + b"=" + value
    return struct.pack("<I", len(f)) + f


def _record(header_fields: dict, data: bytes) -> bytes:
    h = b"".join(_field(k, v) for k, v in header_fields.items())
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ser_header(stamp: float, frame: str = "") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fb = frame.encode()
    return struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", len(fb)) + fb


def serialize_imu(stamp, acc, gyr) -> bytes:
    out = _ser_header(stamp)
    out += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *gyr)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *acc)
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def serialize_livox(stamp, xyz, reflectivity, offset_ns, tag, line) -> bytes:
    n = len(xyz)
    out = _ser_header(stamp, "livox_frame")
    out += struct.pack("<QIB3B", int(stamp * 1e9), n, 0, 0, 0, 0)
    out += struct.pack("<I", n)
    rec = np.zeros(n, dtype=np.dtype(
        [("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")]))
    rec["offset_time"] = offset_ns
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["reflectivity"] = reflectivity
    rec["tag"] = tag
    rec["line"] = line
    return out + rec.tobytes()


def serialize_pointcloud2(stamp, fields_arrays: dict) -> bytes:
    """fields_arrays: ordered {name: np 1-D array}; builds a dense cloud."""
    names = list(fields_arrays.keys())
    arrs = [np.ascontiguousarray(fields_arrays[k]) for k in names]
    n = len(arrs[0])
    dt_codes = {np.dtype(np.int8): 1, np.dtype(np.uint8): 2,
                np.dtype(np.int16): 3, np.dtype(np.uint16): 4,
                np.dtype(np.int32): 5, np.dtype(np.uint32): 6,
                np.dtype(np.float32): 7, np.dtype(np.float64): 8}
    out = _ser_header(stamp, "lidar")
    out += struct.pack("<II", 1, n)  # height, width
    out += struct.pack("<I", len(names))
    off = 0
    offsets = []
    for a in arrs:
        offsets.append(off)
        off += a.dtype.itemsize
    point_step = off
    for name, a, o in zip(names, arrs, offsets):
        nb = name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<IBI", o, dt_codes[a.dtype], 1)
    raw = np.zeros((n, point_step), np.uint8)
    for a, o in zip(arrs, offsets):
        raw[:, o:o + a.dtype.itemsize] = (
            a.view(np.uint8).reshape(n, a.dtype.itemsize))
    out += struct.pack("<BII", 0, point_step, point_step * n)
    out += struct.pack("<I", raw.nbytes) + raw.tobytes()
    out += struct.pack("<B", 1)
    return out


class BagWriter:
    """Minimal ROS1 bag v2.0 writer (uncompressed single chunk)."""

    def __init__(self, path):
        self.path = Path(path)
        self._conns = {}  # topic -> (conn_id, type)
        self._chunk = b""

    def _conn(self, topic: str, mtype: str) -> int:
        if topic in self._conns:
            return self._conns[topic][0]
        cid = len(self._conns)
        self._conns[topic] = (cid, mtype)
        conn_data = (_field("topic", topic.encode())
                     + _field("type", mtype.encode())
                     + _field("md5sum", b"0" * 32)
                     + _field("message_definition", b""))
        self._chunk += _record(
            {"op": b"\x07", "conn": struct.pack("<I", cid),
             "topic": topic.encode()}, conn_data)
        return cid

    def write(self, topic: str, mtype: str, stamp: float, data: bytes):
        cid = self._conn(topic, mtype)
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self._chunk += _record(
            {"op": b"\x02", "conn": struct.pack("<I", cid),
             "time": struct.pack("<II", secs, nsecs)}, data)

    def close(self):
        with open(self.path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            f.write(_record(
                {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                 "conn_count": struct.pack("<I", len(self._conns)),
                 "chunk_count": struct.pack("<I", 1)},
                b"\x00" * 4096))
            f.write(_record(
                {"op": b"\x05", "compression": b"none",
                 "size": struct.pack("<I", len(self._chunk))}, self._chunk))


def replay_into_pipeline(bag_path, pipeline, lidar_topic, imu_topic,
                         cfg=None, max_scans=None, on_scan=None):
    """Feed a bag through a Pipeline (the `rosbag play` analog).

    ``on_scan(pipeline)`` is invoked after every processed packet — the
    publish-callback hook (pcd accumulation, live visualization, ...)."""
    cfg = cfg or pipeline.cfg
    n_scans = 0
    n_imu = 0

    def _spin_all():
        while pipeline.spin_once():
            if on_scan is not None:
                on_scan(pipeline)

    reader = BagReader(bag_path)
    try:
        for topic, mtype, stamp, msg in reader.messages({lidar_topic,
                                                         imu_topic}):
            if topic == imu_topic:
                n_imu += 1
                pipeline.push_imu(msg["stamp"], msg["linear_acceleration"],
                                  msg["angular_velocity"])
            else:
                t0 = time.perf_counter()
                scan = decode(msg, cfg)
                pre_t = time.perf_counter() - t0
                pipeline.push_lidar(msg["stamp"], scan.pts,
                                    scan.time_offset_s, scan.intensity,
                                    preprocess_time=pre_t)
                n_scans += 1
                if max_scans and n_scans >= max_scans:
                    break
            _spin_all()
        _spin_all()
        connections = reader.connections
    finally:
        reader.close()
    if n_scans == 0 or n_imu == 0:
        avail = ", ".join(
            f"{t} ({m})" for t, m in sorted(connections.items())
        ) or "<none>"
        missing = []
        if n_scans == 0:
            missing.append(f"lidar topic {lidar_topic!r}")
        if n_imu == 0:
            missing.append(f"imu topic {imu_topic!r}")
        raise BagFormatError(
            f"{bag_path}: no messages matched {' / '.join(missing)}; "
            f"topics in this bag: {avail}. "
            "Pass --lid-topic/--imu-topic matching the recording "
            "(HKU avia bags: /livox/lidar + /livox/imu; NCLT: "
            "/velodyne_points + /imu/data — see README 'Real datasets').")
    return n_scans
