#!/usr/bin/env python
"""Convert a ROS1 bag of sensor_msgs/PointCloud2 scans into a scan log
(`.islog`) through the PyTorch/CUDA port's `runtime.ScanLogWriter`: the
counterpart of `tools/bag2islog.py`, which writes the same bytes.

The reference consumes `spot_corridor.bag`: organized 64x1024 Ouster clouds
with per-point intensity on /os_cloud_node/points.  This converter parses
the rosbag 2.0 file format directly (no ROS installation): record chunks
(uncompressed or bz2), connection records, and PointCloud2 messages,
extracting x/y/z/intensity fields into the fixed-frame scan log that the
native runtime maps.

Usage:
  python tools/torch_bag2islog.py input.bag output.islog \
      [--topic /os_cloud_node/points] [--height 64] [--width 1024] [--device cuda]

The conversion is host work (numpy and the native writer).  `--device`
names the device the log is meant for and is checked like every tool's:
without a card, the default `cuda` raises.
"""

from __future__ import annotations

import argparse
import bz2
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from intensity_slam_tpu_torch.runtime import ScanLogWriter  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402


def _read_header(buf: bytes) -> dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off:off + flen]
        off += flen
        key, _, val = entry.partition(b"=")
        fields[key.decode()] = val
    return fields


def _records(data: bytes, off: int = 0, end: int | None = None):
    """Yield (header_fields, payload) rosbag records."""
    end = len(data) if end is None else end
    while off < end:
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        hdr = _read_header(data[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", data, off)
        off += 4
        payload = data[off:off + dlen]
        off += dlen
        yield hdr, payload


def _parse_pointcloud2(msg: bytes):
    """Minimal sensor_msgs/PointCloud2 deserializer.

    Layout: Header(seq u32, stamp sec/nsec u32, frame_id string),
    height u32, width u32, fields PointField[], is_bigendian u8,
    point_step u32, row_step u32, data u8[], is_dense u8.
    """
    off = 4  # seq
    sec, nsec = struct.unpack_from("<II", msg, off)
    off += 8
    (slen,) = struct.unpack_from("<I", msg, off)
    off += 4 + slen
    height, width = struct.unpack_from("<II", msg, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", msg, off)
    off += 4
    fields = {}
    for _ in range(nfields):
        (nlen,) = struct.unpack_from("<I", msg, off)
        off += 4
        name = msg[off:off + nlen].decode()
        off += nlen
        foff, dtype, count = struct.unpack_from("<IBI", msg, off)
        off += 9
        fields[name] = (foff, dtype, count)
    off += 1  # is_bigendian
    point_step, _row_step = struct.unpack_from("<II", msg, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", msg, off)
    off += 4
    data = np.frombuffer(msg, np.uint8, dlen, off)
    ts = sec + nsec * 1e-9
    return ts, height, width, fields, point_step, data


_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _extract(data: np.ndarray, point_step: int, fields, name: str):
    foff, dt, _ = fields[name]
    np_dt = _PF_DTYPES[dt]
    n = data.shape[0] // point_step
    raw = np.lib.stride_tricks.as_strided(
        data[foff:], shape=(n, np.dtype(np_dt).itemsize),
        strides=(point_step, 1))
    return raw.copy().view(np_dt).reshape(n).astype(np.float32)


def convert(bag_path: str, out_path: str, topic: str, height: int,
            width: int) -> int:
    with open(bag_path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#ROSBAG V2.0\n"):
        raise ValueError("not a rosbag 2.0 file")
    conn_for_topic: set[int] = set()
    writer = None
    n_written = 0

    def handle_message(hdr, payload):
        nonlocal writer, n_written
        conn = struct.unpack("<I", hdr["conn"])[0]
        if conn not in conn_for_topic:
            return
        ts, h, w, fields, step, pdata = _parse_pointcloud2(payload)
        if h * w != height * width:
            return
        xyz = np.stack([_extract(pdata, step, fields, k)
                        for k in ("x", "y", "z")], -1)
        inten = _extract(pdata, step, fields, "intensity")
        if writer is None:
            writer = ScanLogWriter(out_path, height, width)
        writer.append(ts, np.nan_to_num(xyz), np.nan_to_num(inten))
        n_written += 1

    def handle(hdr, payload):
        op = hdr["op"][0]
        if op == 0x07:  # connection
            conn_fields = _read_header(payload)
            if conn_fields.get("topic", b"").decode() == topic:
                conn_for_topic.add(struct.unpack("<I", hdr["conn"])[0])
        elif op == 0x02:  # message data
            handle_message(hdr, payload)

    for hdr, payload in _records(data, 13):
        op = hdr["op"][0]
        if op == 0x05:  # chunk
            comp = hdr.get("compression", b"none").decode()
            chunk = bz2.decompress(payload) if comp == "bz2" else payload
            for chdr, cpayload in _records(chunk):
                handle(chdr, cpayload)
        else:
            handle(hdr, payload)

    if writer is not None:
        writer.close()
    return n_written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bag")
    ap.add_argument("out")
    ap.add_argument("--topic", default="/os_cloud_node/points")
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    devices.resolve(args.device)
    n = convert(args.bag, args.out, args.topic, args.height, args.width)
    print(f"wrote {n} frames -> {args.out}")
    return 0 if n > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
