"""Minimal pure-Python rosbag (format 2.0) reader + ESVIO sequence converter
(a copy of esvio_tpu/io/rosbag.py, which the port does not import).

The reference replays rosbags through ROS (script/run.sh:22-24); this module
converts the same bags offline into the packed-array SequenceData the
pipeline consumes.  Supports exactly what the ESVIO datasets need:

  * records: BAG_HEADER(3), CHUNK(5) [none|bz2 compression], CONNECTION(7),
    MESSAGE_DATA(2), INDEX_DATA(4)/CHUNK_INFO(6) skipped
  * messages: dvs_msgs/EventArray, sensor_msgs/Imu, sensor_msgs/Image,
    geometry_msgs/PoseStamped + nav_msgs/Odometry (ground truth)

Bag format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""
from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _read_header(buf: bytes) -> Dict[str, bytes]:
    """Parse a rosbag record header: sequence of len-prefixed name=value."""
    out = {}
    i = 0
    n = len(buf)
    while i < n:
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        field = buf[i:i + flen]
        i += flen
        eq = field.index(b"=")
        out[field[:eq].decode()] = field[eq + 1:]
    return out


def _records(data: bytes) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    """Yield (header, payload) records from a raw byte region."""
    i = 0
    n = len(data)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", data, i)
        i += 4
        hdr = _read_header(data[i:i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", data, i)
        i += 4
        yield hdr, data[i:i + dlen]
        i += dlen


def read_messages(path, topics=None) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, datatype, stamp_sec, raw_message) in file order.

    stamp is the record (receive) time; message-internal header stamps are
    decoded by the per-type parsers below.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a rosbag 2.0 file: {path!r}")
        data = f.read()

    connections: Dict[int, Tuple[str, str]] = {}

    def handle_record(hdr, payload):
        op = hdr["op"][0]
        if op == OP_CONNECTION:
            conn = struct.unpack("<I", hdr["conn"])[0]
            fields = _read_header(payload)
            connections[conn] = (hdr["topic"].decode(),
                                 fields.get("type", b"").decode())
        elif op == OP_MESSAGE_DATA:
            conn = struct.unpack("<I", hdr["conn"])[0]
            secs, nsecs = struct.unpack("<II", hdr["time"])
            topic, dtype = connections.get(conn, ("?", "?"))
            if topics is None or topic in topics:
                return topic, dtype, secs + nsecs * 1e-9, payload
        return None

    for hdr, payload in _records(data):
        op = hdr["op"][0]
        if op == OP_CHUNK:
            comp = hdr.get("compression", b"none")
            if comp == b"bz2":
                payload = bz2.decompress(payload)
            elif comp == b"lz4":
                try:
                    import lz4.frame
                    payload = lz4.frame.decompress(payload)
                except ImportError as e:
                    raise RuntimeError("lz4-compressed bag; lz4 unavailable") \
                        from e
            for h2, p2 in _records(payload):
                msg = handle_record(h2, p2)
                if msg is not None:
                    yield msg
        elif op in (OP_CONNECTION, OP_MESSAGE_DATA):   # unchunked (rare)
            msg = handle_record(hdr, payload)
            if msg is not None:
                yield msg
    # note: INDEX_DATA / CHUNK_INFO records are skipped by design


# ------------------------------------------------------------ msg parsers

def _string(buf, i):
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4:i + 4 + n], i + 4 + n


def _header(buf, i=0):
    """std_msgs/Header → (stamp_sec, next_offset)."""
    i += 4  # seq
    secs, nsecs = struct.unpack_from("<II", buf, i)
    i += 8
    _, i = _string(buf, i)  # frame_id
    return secs + nsecs * 1e-9, i


def parse_imu(buf):
    """sensor_msgs/Imu → (stamp, acc (3,), gyr (3,))."""
    stamp, i = _header(buf)
    i += 4 * 8          # orientation quaternion (x y z w)
    i += 9 * 8          # orientation covariance
    gyr = np.frombuffer(buf, np.float64, 3, i)
    i += 3 * 8 + 9 * 8  # angular_velocity + its covariance
    acc = np.frombuffer(buf, np.float64, 3, i)
    return stamp, acc.copy(), gyr.copy()


def parse_event_array(buf):
    """dvs_msgs/EventArray → (t (N,), x (N,), y (N,), p (N,)).

    Event layout (dvs_msgs/Event.msg): uint16 x, uint16 y, time ts,
    bool polarity → 13 bytes packed.
    """
    _, i = _header(buf)
    i += 8  # height, width
    (n,) = struct.unpack_from("<I", buf, i)
    i += 4
    raw = np.frombuffer(buf, np.uint8, n * 13, i).reshape(n, 13)
    x = raw[:, 0:2].copy().view(np.uint16)[:, 0].astype(np.int32)
    y = raw[:, 2:4].copy().view(np.uint16)[:, 0].astype(np.int32)
    secs = raw[:, 4:8].copy().view(np.uint32)[:, 0].astype(np.float64)
    nsecs = raw[:, 8:12].copy().view(np.uint32)[:, 0].astype(np.float64)
    t = secs + nsecs * 1e-9
    p = raw[:, 12].astype(np.int32)
    return t, x, y, p


def parse_image(buf):
    """sensor_msgs/Image → (stamp, (H, W) uint8 grayscale)."""
    stamp, i = _header(buf)
    h, w = struct.unpack_from("<II", buf, i)
    i += 8
    enc, i = _string(buf, i)
    i += 1  # is_bigendian
    (step,) = struct.unpack_from("<I", buf, i)
    i += 4
    (n,) = struct.unpack_from("<I", buf, i)
    i += 4
    img = np.frombuffer(buf, np.uint8, n, i).reshape(h, step)
    enc = enc.decode()
    if enc in ("mono8", "8UC1"):
        return stamp, img[:, :w].copy()
    if enc in ("rgb8", "bgr8"):
        c = img[:, :w * 3].reshape(h, w, 3).astype(np.float32)
        wts = [0.299, 0.587, 0.114] if enc == "rgb8" else [0.114, 0.587, 0.299]
        return stamp, (c @ np.asarray(wts)).astype(np.uint8)
    raise ValueError(f"unsupported image encoding {enc}")


def parse_pose(buf, datatype):
    """geometry_msgs/PoseStamped | nav_msgs/Odometry → (stamp, P (3,))."""
    stamp, i = _header(buf)
    if datatype.endswith("Odometry"):
        _, i = _string(buf, i)  # child_frame_id
    P = np.frombuffer(buf, np.float64, 3, i)
    return stamp, P.copy()


def convert_rosbag(path, event_left, event_right=None, imu=None,
                   image_left=None, image_right=None, gt=None):
    """Convert a rosbag to SequenceData given the reference's topic names
    (config/*/esvio.yaml:4-8, e.g. /davis_left/events, /davis_left/imu)."""
    from esvio_tpu_torch.io.datasets import EventStream, ImuStream, SequenceData

    topics = {t for t in (event_left, event_right, imu, image_left,
                          image_right, gt) if t}
    ev = {event_left: [], event_right: []}
    imu_rows = []
    imgs = {image_left: [], image_right: []}
    gt_rows = []
    for topic, dtype, stamp, raw in read_messages(path, topics):
        if topic in (event_left, event_right):
            ev[topic].append(parse_event_array(raw))
        elif topic == imu:
            imu_rows.append(parse_imu(raw))
        elif topic in (image_left, image_right):
            imgs[topic].append(parse_image(raw))
        elif topic == gt:
            gt_rows.append(parse_pose(raw, dtype))

    def ev_stream(topic):
        if not topic or not ev.get(topic):
            return None
        t = np.concatenate([e[0] for e in ev[topic]])
        x = np.concatenate([e[1] for e in ev[topic]])
        y = np.concatenate([e[2] for e in ev[topic]])
        p = np.concatenate([e[3] for e in ev[topic]])
        order = np.argsort(t, kind="stable")
        return EventStream(t[order], x[order], y[order], p[order])

    def img_stack(topic):
        if not topic or not imgs.get(topic):
            return None
        ts = np.asarray([s for s, _ in imgs[topic]])
        fr = np.stack([f for _, f in imgs[topic]])
        return ts, fr

    imu_s = None
    if imu_rows:
        imu_rows.sort(key=lambda r: r[0])
        imu_s = ImuStream(np.asarray([r[0] for r in imu_rows]),
                          np.stack([r[1] for r in imu_rows]),
                          np.stack([r[2] for r in imu_rows]))
    gt_t = gt_P = None
    if gt_rows:
        gt_rows.sort(key=lambda r: r[0])
        gt_t = np.asarray([r[0] for r in gt_rows])
        gt_P = np.stack([r[1] for r in gt_rows])

    left = ev_stream(event_left)
    right = ev_stream(event_right) or left
    return SequenceData(left, right, imu_s, img_stack(image_left),
                        img_stack(image_right),
                        (gt_t, gt_P) if gt_t is not None else None)
