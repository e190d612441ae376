"""Record a CFS front-end stream from an EuRoC-ASL sequence, with the
PyTorch port's modules (the counterpart of `scripts/record_cfs.py`).

Demonstrates the generic attachment pipeline end-to-end: any odometry
source -> CFS file -> `python -m covins_tpu_torch frontend --stream` ->
server.  Here the
odometry is the sequence's ground-truth state (optionally drifted), i.e.
the same isolation-of-backend trick the replay agent uses — but the
output file is exactly what a third-party VIO system would record.

Usage:
  python scripts/port_record_cfs.py --euroc datasets/MH_01_easy --out mh01.cfs \
      [--max-frames 500] [--with-imu]
"""

import argparse
import csv
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--euroc", required=True,
                    help="sequence dir (containing mav0/)")
    ap.add_argument("--out", required=True, help="output .cfs path")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--every", type=int, default=1,
                    help="record every Nth camera frame")
    ap.add_argument("--with-imu", action="store_true",
                    help="include the IMU window per frame")
    args = ap.parse_args()

    import cv2

    from covins_tpu_torch.agents.euroc_agent import (
        EUROC_DIST, EUROC_INTRINSICS, EUROC_T_BS, _pose_from_44)
    from covins_tpu_torch.comm import messages as msgs
    from covins_tpu_torch.io import stream as cfs

    mav0 = os.path.join(args.euroc, "mav0")
    if not os.path.isdir(mav0):
        mav0 = args.euroc
    cam_dir = os.path.join(mav0, "cam0")
    gt = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0",
                                 "data.csv"), delimiter=",", skiprows=1)
    imu = (np.loadtxt(os.path.join(mav0, "imu0", "data.csv"),
                      delimiter=",", skiprows=1)
           if args.with_imu else None)

    frames = []
    with open(os.path.join(cam_dir, "data.csv")) as fh:
        for row in csv.reader(fh):
            if row and row[0][0].isdigit():
                frames.append((int(row[0]), row[1].strip()))
    frames = frames[:: args.every]

    calib = msgs.VICalibration(
        T_s_c=_pose_from_44(EUROC_T_BS), cam_model=0, dist_model=1,
        intrinsics=EUROC_INTRINSICS.copy(), dist=EUROC_DIST.copy(),
        img_w=752, img_h=480,
    )
    n = 0
    prev_t = None
    with cfs.StreamWriter(args.out) as w:
        w.write_calibration(calib)
        for t_ns, fname in frames:
            if not (gt[0, 0] <= t_ns <= gt[-1, 0]):
                continue
            i = int(np.clip(np.searchsorted(gt[:, 0], t_ns), 0,
                            len(gt) - 1))
            q = gt[i, 4:8] / np.linalg.norm(gt[i, 4:8])
            T_w_s = np.concatenate([q, gt[i, 1:4]])
            img = cv2.imread(os.path.join(cam_dir, "data", fname),
                             cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            kw = {}
            if imu is not None and prev_t is not None:
                sel = (imu[:, 0] > prev_t) & (imu[:, 0] <= t_ns)
                win = imu[sel]
                if len(win) >= 2:
                    kw = dict(
                        acc=win[:, 4:7], gyro=win[:, 1:4],
                        imu_dts=np.diff(win[:, 0], prepend=prev_t) * 1e-9,
                    )
            w.write_frame(t_ns * 1e-9, T_w_s, image=img,
                          velocity=gt[i, 8:11] if gt.shape[1] > 10 else None,
                          **kw)
            prev_t = t_ns
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    print(f"[port_record_cfs] wrote {n} frames -> {args.out}")


if __name__ == "__main__":
    main()
