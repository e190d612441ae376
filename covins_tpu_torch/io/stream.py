"""CFS — the COVINS-TPU frontend stream format.

Counterpart of `covins_tpu/io/stream.py`, writing the same bytes (the JSON
header's separators and key order, `dtype.str`), so a stream written by
either package reads back in the other.

The attachment contract for REAL front-ends (the role of the reference's
`covins_frontend` wrapper, `frontend_wrapper.cpp:16-32`): any VIO/odometry
system — ORB-SLAM3, VINS, a custom tracker, another process, another
language — records its per-frame output in this container (or speaks the
live TCP wire protocol directly, `covins_tpu_torch.comm.wire`), and
`covins_tpu_torch.agents.frontend_adapter.FrontendWrapper` turns it into
schema-complete `MsgKeyframe` traffic for the server.

Deliberately trivial to produce without this codebase:

    magic   :  b"CFSTREAM1\\n"
    record  :  u32 big-endian total length, then
               u32 big-endian JSON header length, JSON header (utf-8),
               raw little-endian array payload bytes (concatenated)

Header fields:
    {"kind": "calib" | "frame",
     ... scalar fields ...,
     "arrays": [{"name": .., "dtype": "<f8"|"|u1"|.., "shape": [..]}, ..]}

Array payloads follow the header in `arrays` order, C-contiguous, packed
back-to-back (offsets are implied by dtype x shape).

`calib` record (first in the stream) scalar fields: `cam_model`,
`dist_model`, `img_w`, `img_h`, plus optional IMU noise scalars; arrays:
`T_s_c` (7,) [qw qx qy qz t], `intrinsics` (5,), `dist` (4,).

`frame` record scalar fields: `timestamp` (seconds, float); arrays —
either of:
    `image`   (H, W) u1 grayscale            (adapter extracts ORB), or
    `keypoints` (F, 2) f4 pixel coords + `descriptors` (F, 32) u1 packed
        ORB (the front-end already extracted), optional `keypoints_aors`
        (F, 4) f4 [angle octave response size];
plus `T_w_s` (7,) odometry body pose (world-from-body, [qw qx qy qz t]),
and optionally `acc` (S, 3) f8 / `gyro` (S, 3) f8 / `imu_dts` (S,) f8 for
the IMU window since the previous frame, and `velocity` (3,) f8.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, Optional

import numpy as np

from covins_tpu_torch.comm import messages as msgs

MAGIC = b"CFSTREAM1\n"


def _pack_record(kind: str, scalars: dict, arrays: dict) -> bytes:
    specs = []
    payload = b""
    for name, arr in arrays.items():
        if arr is None:
            continue
        arr = np.ascontiguousarray(arr)
        specs.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
        })
        payload += arr.tobytes()
    header = json.dumps(
        {"kind": kind, **scalars, "arrays": specs}, separators=(",", ":")
    ).encode()
    body = struct.pack(">I", len(header)) + header + payload
    return struct.pack(">I", len(body)) + body


class StreamWriter:
    """Writes a CFS stream.  Used by tests and by the provided recorders;
    a third-party front-end can emit the same bytes from any language."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)

    def write_calibration(self, calib: msgs.VICalibration) -> None:
        self._fh.write(_pack_record(
            "calib",
            {
                "cam_model": int(calib.cam_model),
                "dist_model": int(calib.dist_model),
                "img_w": int(calib.img_w),
                "img_h": int(calib.img_h),
                "acc_noise": calib.acc_noise,
                "gyro_noise": calib.gyro_noise,
                "acc_walk": calib.acc_walk,
                "gyro_walk": calib.gyro_walk,
                "imu_rate": calib.imu_rate,
                "gravity_mag": calib.gravity_mag,
            },
            {
                "T_s_c": np.asarray(calib.T_s_c, np.float64),
                "intrinsics": np.asarray(calib.intrinsics, np.float64),
                "dist": np.asarray(calib.dist, np.float64),
            },
        ))

    def write_frame(
        self,
        timestamp: float,
        T_w_s: np.ndarray,
        image: Optional[np.ndarray] = None,
        keypoints: Optional[np.ndarray] = None,
        descriptors: Optional[np.ndarray] = None,
        keypoints_aors: Optional[np.ndarray] = None,
        acc: Optional[np.ndarray] = None,
        gyro: Optional[np.ndarray] = None,
        imu_dts: Optional[np.ndarray] = None,
        velocity: Optional[np.ndarray] = None,
    ) -> None:
        self._fh.write(_pack_record(
            "frame",
            {"timestamp": float(timestamp)},
            {
                "T_w_s": np.asarray(T_w_s, np.float64),
                "image": image,
                "keypoints": keypoints,
                "descriptors": descriptors,
                "keypoints_aors": keypoints_aors,
                "acc": acc,
                "gyro": gyro,
                "imu_dts": imu_dts,
                "velocity": velocity,
            },
        ))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_stream(path: str) -> Iterator[dict]:
    """Yields records as dicts: scalar header fields + named numpy arrays
    under their array names; `kind` distinguishes calib/frame."""
    with open(path, "rb") as fh:
        if fh.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a CFS stream (bad magic)")
        while True:
            lenb = fh.read(4)
            if len(lenb) < 4:
                return
            (total,) = struct.unpack(">I", lenb)
            body = fh.read(total)
            if len(body) < total:
                raise ValueError(f"{path}: truncated record")
            (hlen,) = struct.unpack(">I", body[:4])
            header = json.loads(body[4 : 4 + hlen].decode())
            off = 4 + hlen
            rec = {k: v for k, v in header.items() if k != "arrays"}
            for spec in header["arrays"]:
                dt = np.dtype(spec["dtype"])
                n = int(np.prod(spec["shape"])) if spec["shape"] else 1
                nbytes = n * dt.itemsize
                rec[spec["name"]] = np.frombuffer(
                    body[off : off + nbytes], dtype=dt
                ).reshape(spec["shape"]).copy()
                off += nbytes
            yield rec


def read_calibration(rec: dict) -> msgs.VICalibration:
    """`calib` record dict -> VICalibration."""
    return msgs.VICalibration(
        T_s_c=rec["T_s_c"],
        cam_model=int(rec["cam_model"]),
        dist_model=int(rec["dist_model"]),
        intrinsics=rec["intrinsics"],
        dist=rec["dist"],
        img_w=int(rec["img_w"]),
        img_h=int(rec["img_h"]),
        acc_noise=float(rec.get("acc_noise", 2.0e-3)),
        gyro_noise=float(rec.get("gyro_noise", 1.7e-4)),
        acc_walk=float(rec.get("acc_walk", 3.0e-3)),
        gyro_walk=float(rec.get("gyro_walk", 2.0e-5)),
        imu_rate=float(rec.get("imu_rate", 200.0)),
        gravity_mag=float(rec.get("gravity_mag", 9.81)),
    )
