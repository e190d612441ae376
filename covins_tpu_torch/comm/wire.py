"""Wire protocol: length-framed binary message encoding.

Counterpart of `covins_tpu/comm/wire.py`, byte for byte: an agent of
either package talks to a server of either.  It replaces the reference's
cereal + hand-rolled big-endian framed TCP
(`covins_comm/src/covins_base/communicator_base.cpp` — 10x5-uint32 header
containers `:276-315`, `packi32/unpacki32` `:127-138,394-402`,
`SendAll`/`RecvAll` loops `:317-360,404-430`) with one frame per message,

    magic u32 'CVNS' | version u8 | msg_type u8 | reserved u16 | payload u64

followed by a generic field record: every message is a flat dict of numpy
arrays / scalars / strings, serialized as

    n_fields u16, then per field:
    name_len u16 | name utf8 | kind u8 (0=array,1=str,2=none)
    [arrays]  dtype_len u8 | dtype str | ndim u8 | shape i64*ndim | raw bytes
    [strings] len u32 | utf8

All numeric data is little-endian raw memory (`tobytes`).  The same layout
is implemented by the native C++ codec (`native/wirecodec.cpp`, built by
`comm/native_codec.py`), byte-identical; `use_native()` switches the
encode/decode path to it once its self-check passes.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

from covins_tpu_torch.comm import messages as msgs

MAGIC = 0x43564E53  # 'CVNS'
VERSION = 1

_HDR = struct.Struct("<IBBHQ")

KIND_ARRAY = 0
KIND_STR = 1
KIND_NONE = 2


# ---------------------------------------------------------------------------
# generic record <-> bytes
# ---------------------------------------------------------------------------


def encode_record(rec: Dict[str, object]) -> bytes:
    out = [struct.pack("<H", len(rec))]
    for name, val in rec.items():
        nb = name.encode()
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        if val is None:
            out.append(struct.pack("<B", KIND_NONE))
        elif isinstance(val, str):
            vb = val.encode()
            out.append(struct.pack("<B", KIND_STR))
            out.append(struct.pack("<I", len(vb)))
            out.append(vb)
        else:
            # np.ascontiguousarray promotes 0-d to 1-d; keep scalars 0-d so
            # they decode back to scalars
            arr = np.asarray(val)
            if arr.ndim:
                arr = np.ascontiguousarray(arr)
            ds = arr.dtype.str  # e.g. '<f8'
            out.append(struct.pack("<B", KIND_ARRAY))
            dsb = ds.encode()
            out.append(struct.pack("<B", len(dsb)))
            out.append(dsb)
            out.append(struct.pack("<B", arr.ndim))
            out.append(struct.pack(f"<{arr.ndim}q", *arr.shape) if arr.ndim else b"")
            out.append(arr.tobytes())
    return b"".join(out)


def decode_record(buf: memoryview) -> Dict[str, object]:
    rec: Dict[str, object] = {}
    (n_fields,) = struct.unpack_from("<H", buf, 0)
    off = 2
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<H", buf, off); off += 2
        name = bytes(buf[off : off + nlen]).decode(); off += nlen
        (kind,) = struct.unpack_from("<B", buf, off); off += 1
        if kind == KIND_NONE:
            rec[name] = None
        elif kind == KIND_STR:
            (slen,) = struct.unpack_from("<I", buf, off); off += 4
            rec[name] = bytes(buf[off : off + slen]).decode(); off += slen
        else:
            (dlen,) = struct.unpack_from("<B", buf, off); off += 1
            dtype = np.dtype(bytes(buf[off : off + dlen]).decode()); off += dlen
            (ndim,) = struct.unpack_from("<B", buf, off); off += 1
            shape = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
            off += 8 * ndim
            count = int(np.prod(shape)) if ndim else 1
            nbytes = count * dtype.itemsize
            arr = np.frombuffer(buf[off : off + nbytes], dtype=dtype).reshape(shape)
            off += nbytes
            rec[name] = arr if ndim else arr[()]
    return rec


def frame(msg_type: int, payload: bytes) -> bytes:
    return _HDR.pack(MAGIC, VERSION, msg_type, 0, len(payload)) + payload


def parse_header(buf: bytes) -> Tuple[int, int]:
    magic, ver, msg_type, _, plen = _HDR.unpack(buf)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if ver != VERSION:
        raise ValueError(f"unsupported wire version {ver}")
    return msg_type, plen


HEADER_SIZE = _HDR.size


# ---------------------------------------------------------------------------
# message <-> record
# ---------------------------------------------------------------------------


def _calib_rec(c: Optional[msgs.VICalibration]) -> Dict[str, object]:
    if c is None:
        return {"calib": None}
    return {
        "calib.T_s_c": c.T_s_c, "calib.cam_model": np.int32(c.cam_model),
        "calib.dist_model": np.int32(c.dist_model),
        "calib.intrinsics": c.intrinsics, "calib.dist": c.dist,
        "calib.img_w": np.int32(c.img_w), "calib.img_h": np.int32(c.img_h),
        "calib.acc_noise": np.float64(c.acc_noise),
        "calib.gyro_noise": np.float64(c.gyro_noise),
        "calib.acc_walk": np.float64(c.acc_walk),
        "calib.gyro_walk": np.float64(c.gyro_walk),
        "calib.imu_rate": np.float64(c.imu_rate),
        "calib.gravity_mag": np.float64(c.gravity_mag),
    }


def _f(x) -> float:
    """Scalar from a decoded field that may arrive as a 1-element array."""
    return float(np.asarray(x).reshape(-1)[0])


def _calib_from(rec) -> Optional[msgs.VICalibration]:
    if "calib.T_s_c" not in rec:
        return None
    return msgs.VICalibration(
        T_s_c=np.asarray(rec["calib.T_s_c"]),
        cam_model=int(_f(rec["calib.cam_model"])),
        dist_model=int(_f(rec["calib.dist_model"])),
        intrinsics=np.asarray(rec["calib.intrinsics"]),
        dist=np.asarray(rec["calib.dist"]),
        img_w=int(_f(rec["calib.img_w"])), img_h=int(_f(rec["calib.img_h"])),
        acc_noise=_f(rec["calib.acc_noise"]),
        gyro_noise=_f(rec["calib.gyro_noise"]),
        acc_walk=_f(rec["calib.acc_walk"]),
        gyro_walk=_f(rec["calib.gyro_walk"]),
        imu_rate=_f(rec["calib.imu_rate"]),
        gravity_mag=_f(rec["calib.gravity_mag"]),
    )


def encode_message(msg) -> bytes:
    if isinstance(msg, msgs.MsgKeyframe):
        rec: Dict[str, object] = {
            "id": np.asarray(msg.id, np.int64),
            "timestamp": np.float64(msg.timestamp),
            "keypoints": msg.keypoints,
            "keypoints_undist": msg.keypoints_undist,
            "keypoints_aors": msg.keypoints_aors,
            "descriptors": msg.descriptors,
            "id_reference": np.asarray(msg.id_reference, np.int64),
            "T_sref_s": msg.T_sref_s,
            "T_w_s_vio": msg.T_w_s_vio,
            "velocity": msg.velocity,
            "bias_gyro": msg.bias_gyro,
            "bias_acc": msg.bias_acc,
            "landmark_ids": msg.landmark_ids,
            "id_predecessor": np.asarray(msg.id_predecessor, np.int64),
            "id_successor": np.asarray(msg.id_successor, np.int64),
        }
        if msg.keypoints_add is not None:
            rec["keypoints_add"] = msg.keypoints_add
            rec["keypoints_aors_add"] = msg.keypoints_aors_add
            rec["descriptors_add"] = msg.descriptors_add
        if msg.preintegration is not None:
            rec["imu.acc"] = msg.preintegration.acc
            rec["imu.gyro"] = msg.preintegration.gyro
            rec["imu.dts"] = msg.preintegration.dts
        rec.update(_calib_rec(msg.calibration))
        rec.pop("calib", None)
        return frame(msgs.MSG_KEYFRAME, encode_record(rec))
    if isinstance(msg, msgs.MsgKeyframeUpdate):
        rec = {
            "id": np.asarray(msg.id, np.int64),
            "id_reference": np.asarray(msg.id_reference, np.int64),
            "T_sref_s": msg.T_sref_s,
            "velocity": msg.velocity,
            "bias_gyro": msg.bias_gyro,
            "bias_acc": msg.bias_acc,
        }
        return frame(msgs.MSG_KEYFRAME_UPDATE, encode_record(rec))
    if isinstance(msg, msgs.MsgLandmark):
        obs = np.asarray(
            [[k[0], k[1], v] for k, v in msg.observations.items()], np.int64
        ).reshape(-1, 3)
        rec = {
            "id": np.asarray(msg.id, np.int64),
            "id_reference": np.asarray(msg.id_reference, np.int64),
            "pos_ref": msg.pos_ref,
            "observations": obs,
        }
        return frame(msgs.MSG_LANDMARK, encode_record(rec))
    if isinstance(msg, msgs.MsgLandmarkUpdate):
        rec = {
            "id": np.asarray(msg.id, np.int64),
            "id_reference": np.asarray(msg.id_reference, np.int64),
            "pos_ref": msg.pos_ref,
        }
        return frame(msgs.MSG_LANDMARK_UPDATE, encode_record(rec))
    raise TypeError(f"cannot encode {type(msg)}")


def decode_message(msg_type: int, payload: memoryview):
    rec = decode_record(payload)
    if msg_type == msgs.MSG_KEYFRAME:
        pre = None
        if "imu.acc" in rec:
            pre = msgs.PreintegrationData(
                acc=np.asarray(rec["imu.acc"]),
                gyro=np.asarray(rec["imu.gyro"]),
                dts=np.asarray(rec["imu.dts"]),
            )
        return msgs.MsgKeyframe(
            id=tuple(np.asarray(rec["id"]).tolist()),
            timestamp=_f(rec["timestamp"]),
            calibration=_calib_from(rec),
            keypoints=np.asarray(rec["keypoints"]),
            keypoints_undist=np.asarray(rec["keypoints_undist"]),
            keypoints_aors=np.asarray(rec["keypoints_aors"]),
            descriptors=np.asarray(rec["descriptors"]),
            keypoints_add=np.asarray(rec["keypoints_add"]) if "keypoints_add" in rec else None,
            keypoints_aors_add=np.asarray(rec["keypoints_aors_add"]) if "keypoints_aors_add" in rec else None,
            descriptors_add=np.asarray(rec["descriptors_add"]) if "descriptors_add" in rec else None,
            id_reference=tuple(np.asarray(rec["id_reference"]).tolist()),
            T_sref_s=None if rec["T_sref_s"] is None else np.asarray(rec["T_sref_s"]),
            T_w_s_vio=None if rec["T_w_s_vio"] is None else np.asarray(rec["T_w_s_vio"]),
            velocity=None if rec["velocity"] is None else np.asarray(rec["velocity"]),
            bias_gyro=None if rec["bias_gyro"] is None else np.asarray(rec["bias_gyro"]),
            bias_acc=None if rec["bias_acc"] is None else np.asarray(rec["bias_acc"]),
            preintegration=pre,
            landmark_ids=None if rec["landmark_ids"] is None else np.asarray(rec["landmark_ids"]),
            id_predecessor=tuple(np.asarray(rec["id_predecessor"]).tolist()),
            id_successor=tuple(np.asarray(rec["id_successor"]).tolist()),
        )
    if msg_type == msgs.MSG_KEYFRAME_UPDATE:
        return msgs.MsgKeyframeUpdate(
            id=tuple(np.asarray(rec["id"]).tolist()),
            id_reference=tuple(np.asarray(rec["id_reference"]).tolist()),
            T_sref_s=np.asarray(rec["T_sref_s"]),
            velocity=np.asarray(rec["velocity"]),
            bias_gyro=np.asarray(rec["bias_gyro"]),
            bias_acc=np.asarray(rec["bias_acc"]),
        )
    if msg_type == msgs.MSG_LANDMARK:
        obs = np.asarray(rec["observations"]).reshape(-1, 3)
        return msgs.MsgLandmark(
            id=tuple(np.asarray(rec["id"]).tolist()),
            id_reference=tuple(np.asarray(rec["id_reference"]).tolist()),
            pos_ref=np.asarray(rec["pos_ref"]),
            observations={(int(r[0]), int(r[1])): int(r[2]) for r in obs},
        )
    if msg_type == msgs.MSG_LANDMARK_UPDATE:
        return msgs.MsgLandmarkUpdate(
            id=tuple(np.asarray(rec["id"]).tolist()),
            id_reference=tuple(np.asarray(rec["id_reference"]).tolist()),
            pos_ref=np.asarray(rec["pos_ref"]),
        )
    raise ValueError(f"unknown msg type {msg_type}")


# ---------------------------------------------------------------------------
# native codec hook (C++ implementation of encode_record/decode_record)
# ---------------------------------------------------------------------------

_native = None


def use_native(lib_path: str = None) -> bool:
    """Load the C++ wire codec (`native/wirecodec.cpp`).  Returns True if
    the shared library was found and self-checks pass."""
    global _native, encode_record, decode_record
    try:
        from covins_tpu_torch.comm import native_codec
        codec = native_codec.load(lib_path)
    except Exception:
        return False
    if codec is None:
        return False
    # self-check: roundtrip a representative record through both paths
    probe = {
        "a": np.arange(12, dtype=np.float64).reshape(3, 4),
        "b": np.uint8(7), "s": "hello", "n": None,
    }
    py_bytes = encode_record(probe)
    if codec.encode_record(probe) != py_bytes:
        return False
    _native = codec
    encode_record = codec.encode_record
    decode_record = codec.decode_record
    return True
