#!/usr/bin/env python3
"""Time K10 (IMU preintegration) and the landmark-attribute refresh (K2) of
the PyTorch port on one CUDA card, at the main path's sizes.

    python scripts/port_k10k2_probe.py [--tree DIR] [--cohorts 1010,N]
        [--save FILE | --compare FILE]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so that two versions can be
compared in one run on one card, in turns; the inputs and the timing come
from this checkout's ``chip_smoke.py`` either way.  ``--save`` writes K10's
outputs to an ``.npz`` file and ``--compare`` holds this tree's outputs to
such a file bit for bit (parent against change).  Prints the card's name
and power limit, then one JSON line with:

* K10: ``imu.preintegrate`` at bench.py's GBA problem (255 factors x 50
  samples) and at the shape ``Map.to_gba_problem`` gives it (255 x 256,
  every factor padded to ``imu_max_samples``), inputs from
  ``chip_smoke.k10_inputs``;
* the refresh: ``Map.update_landmark_attributes`` of the tree on a
  synthetic map (256 keyframes of 1024 features, each landmark seen by 2
  to 20 of them, the window padded to 16) for cohorts of ``--cohorts``
  landmarks (by default 1010, the bench drain's largest, and 1271, the
  five-agent deployment's largest in chip_smoke phase 3): the wall time of
  a refresh with its write-back (host clock; the write-back's copy waits
  for the card), the card's busy time of the refresh without it, its
  kernel launches, and the PyTorch operations of the refresh and of its
  write-back;
* for each K10 shape: the mean time between back-to-back calls (CUDA
  events), the card's busy time per call (the calls queued behind a spin
  kernel, ``chip_smoke.busy_ms``), launches and PyTorch operations;
* the ``-Xptxas -v`` register and spill lines of the two sources.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
K10_FIELDS = ("dq", "dv", "dp", "J_q_bg", "J_v_bg", "J_v_ba", "J_p_bg", "J_p_ba", "cov", "dt")


def synthetic_map(Map, L, dev, rng, K=256, F=1024, pad=16):
    """A map of K keyframes and L landmarks, each seen by 2 to pad + 4
    keyframes (the refresh keeps the first ``pad``)."""
    n = rng.integers(2, pad + 5, L)
    mp = Map(0, max_features=F, kf_capacity=K, lm_capacity=L, obs_capacity=int(n.sum()),
             device=dev)
    mp.n_kf, mp.n_lm, mp.n_obs = K, L, int(n.sum())
    mp.kf_mask[:] = True
    mp.kf_pose[:, 0] = 1.0
    mp.kf_pose[:, 4:7] = rng.normal(scale=5.0, size=(K, 3))
    mp.descriptors[:] = rng.integers(0, 256, mp.descriptors.shape, dtype=np.uint8)
    mp.kp_aors[:, :, 1] = rng.integers(0, 8, (K, F))
    mp.lm_mask[:] = True
    mp.lm_ids[:, 0] = np.arange(L)
    mp.lm_pos[:] = rng.normal(scale=5.0, size=(L, 3))
    mp.obs_lm[:] = np.repeat(np.arange(L), n)
    mp.obs_kf[:] = np.concatenate([rng.choice(K, k, replace=False) for k in n])
    mp.obs_feat[:] = rng.integers(0, F, mp.n_obs)
    mp.obs_mask[:] = True
    return mp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--cohorts", default="1010,1271")
    ap.add_argument("--save")
    ap.add_argument("--compare")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k10k2_probe: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.models.map_store import Map
    from covins_tpu_torch.ops import imu, landmark_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    names = [n for n in ("imu_preintegrate", "representative_descriptors",
                         "landmark_attributes") if n in cuda_build.SIGNATURES]
    logs = cuda_build.build_all(names)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    dev = torch.device("cuda", 0)
    out = {"tree": args.tree, "card": card, "ptxas": ptxas}

    # K10
    noise = imu.default_noise()
    saved = dict(np.load(args.compare)) if args.compare else None
    keep = {}
    for F, S in ((255, 50), (255, 256)):
        k10 = smoke.k10_inputs(np.random.default_rng(smoke.SEED + S), F, S, dev)

        def call():
            return imu.preintegrate(*k10, noise)

        before = imu.preintegrate.launches
        res = call()
        torch.cuda.synchronize()
        row = {"launches": imu.preintegrate.launches - before,
               "call_ms": smoke.cuda_ms(call, 20), "busy_ms": smoke.busy_ms(call, 20),
               "ops_per_call": smoke.count_ops(call)}
        for name in K10_FIELDS:
            keep[f"{S}_{name}"] = getattr(res, name).cpu().numpy()
        if saved is not None:
            row["equal_to_compared"] = all(np.array_equal(keep[f"{S}_{n}"], saved[f"{S}_{n}"])
                                           for n in K10_FIELDS)
        out[f"k10_{F}x{S}"] = row
        print(json.dumps({f"k10_{F}x{S}": row}), flush=True)
    if args.save:
        np.savez(args.save, **keep)

    # the refresh, as the map issues it
    counted = getattr(landmark_ops, "landmark_attributes",
                      getattr(landmark_ops, "representative_descriptors"))
    for L in (int(x) for x in args.cohorts.split(",")):
        mp = synthetic_map(Map, L, dev, np.random.default_rng(smoke.SEED + L))
        rows = np.arange(L)
        mp.update_landmark_attributes(rows)  # warm-up
        torch.cuda.synchronize()
        before = counted.launches
        mp.update_landmark_attributes(rows)
        launches = counted.launches - before
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            mp.update_landmark_attributes(rows)
        wall = (time.perf_counter() - t0) * 1e3 / reps
        busy = smoke.busy_ms(lambda: mp.update_landmark_attributes(rows, lazy=True), reps)
        mp.commit_landmark_attributes()
        ops = smoke.count_ops(lambda: mp.update_landmark_attributes(rows, lazy=True))
        row = {"landmarks": L, "launches": launches, "call_ms": wall, "busy_ms": busy,
               "ops_per_refresh": ops,
               "ops_per_commit": smoke.count_ops(mp.commit_landmark_attributes)}
        out[f"refresh_{L}x16"] = row
        print(json.dumps({f"refresh_{L}x16": row}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
