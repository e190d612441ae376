#!/usr/bin/env python3
"""Time K1 (Hamming word assignment) and a window's insert-and-score (K1
and K3) of the PyTorch port on one CUDA card, at the main path's sizes.

    python scripts/port_k1k3_probe.py [--tree DIR] [--save FILE | --compare FILE]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so that two versions can be
compared in one run on one card, in turns; the inputs and the timing come
from this checkout's ``chip_smoke.py`` either way.  ``--save`` writes K1's
outputs to an ``.npz`` file and ``--compare`` holds this tree's outputs to
such a file bit for bit (parent against change).  Prints the card's name
and power limit, then one JSON line with:

* K1: ``descriptors.hamming_argmin`` at the window's word assignment
  (6480 x 512: 12 keyframes of 540 descriptors against 512 words), at the
  vocabulary training's 8192 x 512 and at 65536 x 1024, each against its
  plain version exactly: the mean time between back-to-back calls (CUDA
  events), the card's busy time per call (the calls queued behind a spin
  kernel, ``chip_smoke.busy_ms``), launches and PyTorch operations;
* the window: ``KeyframeDatabase.add_and_query_batch`` of the tree at 12
  keyframes of 540 descriptors, 512 words, 1024 rows scored
  (``chip_smoke.window_counts``), lazy and not: its PyTorch operations,
  host-to-device and device-to-host copies, host time per call, the
  card's busy time of the lazy call, and the K1 and K3 launches a call
  makes;
* the ``-Xptxas -v`` register and spill lines of the two sources.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k1k3_probe: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import bow, descriptors

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    names = [n for n in ("hamming_argmin", "bow_insert", "bow_insert_score")
             if n in cuda_build.SIGNATURES]
    logs = cuda_build.build_all(names)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    dev = torch.device("cuda", 0)
    out = {"tree": args.tree, "card": card, "ptxas": ptxas}

    # K1
    saved = dict(np.load(args.compare)) if args.compare else None
    keep = {}
    for m, n in ((6480, 512), (8192, 512), (65536, 1024)):
        rng = np.random.default_rng(smoke.SEED + m + n)
        a = torch.from_numpy(rng.integers(0, 256, (m, 32), dtype=np.uint8)).to(dev)
        b = torch.from_numpy(rng.integers(0, 256, (n, 32), dtype=np.uint8)).to(dev)
        mask = torch.from_numpy(rng.random(m) > 0.1).to(dev)

        def call():
            return descriptors.hamming_argmin(a, b, mask)

        before = descriptors.hamming_argmin.launches
        idx, dmin = call()
        launches = descriptors.hamming_argmin.launches - before
        ridx, rdmin = descriptors.hamming_argmin_plain(a, b, mask)
        torch.cuda.synchronize()
        row = {"launches": launches,
               "equal_to_plain": bool(torch.equal(idx, ridx) and torch.equal(dmin, rdmin)),
               "call_ms": smoke.cuda_ms(call, 50), "busy_ms": smoke.busy_ms(call, 50),
               "ops_per_call": smoke.count_ops(call)}
        keep[f"{m}x{n}_idx"], keep[f"{m}x{n}_dmin"] = idx.cpu().numpy(), dmin.cpu().numpy()
        if saved is not None:
            row["equal_to_compared"] = all(np.array_equal(keep[k], saved[k])
                                           for k in (f"{m}x{n}_idx", f"{m}x{n}_dmin"))
        out[f"k1_{m}x{n}"] = row
        print(json.dumps({f"k1_{m}x{n}": row}), flush=True)
    if args.save:
        np.savez(args.save, **keep)

    # the window, as the database issues it
    vocab = np.random.default_rng(smoke.SEED).integers(0, 256, (512, 32), dtype=np.uint8)
    row = smoke.window_counts(vocab, 12, 540, dev, reps=50)
    # the kernel launches of one window, on a fresh database
    from covins_tpu_torch.models.kf_database import KeyframeDatabase

    k3 = getattr(bow, "bow_insert_score", None) or bow.bow_insert
    db = KeyframeDatabase(vocab, capacity=1024, device=dev)
    descs = [np.random.default_rng(i).integers(0, 256, (540, 32), dtype=np.uint8)
             for i in range(12)]
    k1_before, k3_before = descriptors.hamming_argmin.launches, k3.launches
    db.add_and_query_batch([(i, 0) for i in range(12)], descs, lazy=True)
    row["k1_launches_per_window"] = descriptors.hamming_argmin.launches - k1_before
    row["k3_launches_per_window"] = k3.launches - k3_before
    row["k3_counter"] = k3.__name__
    out["window_12x540"] = row
    print(json.dumps({"window_12x540": row}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
