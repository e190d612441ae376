#!/usr/bin/env python3
"""Time K13 (L2 word assignment) and K14 (L2 top-2 ratio matching) of the
PyTorch port on one CUDA card, at the main path's sizes.

    python scripts/port_k13k14_probe.py [--tree DIR]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so that two versions can be
compared in one run on one card, in turns; the inputs and the timing come
from this checkout's ``chip_smoke.py`` either way.  Prints the card's name
and power limit, then one JSON line with, for each shape, the mean time
between back-to-back calls (CUDA events, ``ms``), the card's busy time per
call (``chip_smoke.busy_ms``) and whether the outputs equal the plain
version's bit for bit:

* K13 (``descriptors.l2_argmin``) at 5,336 x 512 (the size of the SIFT
  drain's largest window), 12,288 x 512 (12 keyframes of 1,024 features)
  and 65,536 x 1,024, from ``utils/synthetic.l2_match_scene``;
* K14 (``descriptors.l2_ratio_match``) at the COVINS-G verification's
  2,048 x 3,072 in segments of 1,024: random with a tenth of rows and
  columns masked, and masked as the SIFT drain's input is, the first 310
  of each 1,024 query slots and 260 of each 1,024 candidate slots valid
  (483,600 valid pairs; the drain's recorded input had 476,700);

and the ``-Xptxas -v`` register, shared-memory and spill lines of
``csrc/l2_match.cu``.
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
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k13k14_probe: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import descriptors as d
    from covins_tpu_torch.utils.synthetic import l2_match_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    log = cuda_build.build_all(["l2_match"]).get("l2_match", "")
    dev = torch.device("cuda", 0)
    out = {"tree": args.tree, "card": card,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "smem" in ln]}

    def t(x):
        return torch.from_numpy(x).to(dev)

    for m, n in ((5336, 512), (12288, 512), (65536, 1024)):
        rng = np.random.default_rng(smoke.SEED + m + n)
        a, am, b, _ = (t(x) for x in l2_match_scene(rng, m, n, 1))
        got = d.l2_argmin(a, b, am)
        ref = d.l2_argmin_plain(a, b, am)
        reps = 50 if m * n < 1e7 else 20
        out[f"k13_{m}x{n}"] = {
            "exact": all(torch.equal(g, r) for g, r in zip(got, ref)),
            "ms": smoke.cuda_ms(lambda: d.l2_argmin(a, b, am), reps),
            "busy_ms": smoke.busy_ms(lambda: d.l2_argmin(a, b, am), reps)}
    seg, n_seg = 1024, 3
    for tag in ("random", "drain_masks"):
        rng = np.random.default_rng(smoke.SEED + 2048)
        a, am, b, bm = l2_match_scene(rng, 2048, seg, n_seg)
        if tag == "drain_masks":
            am = np.arange(2048) % 1024 < 310
            bm = np.arange(seg * n_seg) % 1024 < 260
        a, am, b, bm = (t(x) for x in (a, am, b, bm))
        got = d.l2_ratio_match(a, am, b, bm, seg, 500.0, 0.8)
        ref = d.l2_ratio_match_plain(a, am, b, bm, seg, 500.0, 0.8)
        out[f"k14_{tag}"] = {
            "valid_pairs": int(am.sum().item()) * int(bm.sum().item()),
            "exact": all(torch.equal(g, r) for g, r in zip(got, ref)),
            "ms": smoke.cuda_ms(lambda: d.l2_ratio_match(a, am, b, bm, seg, 500.0, 0.8), 50),
            "busy_ms": smoke.busy_ms(lambda: d.l2_ratio_match(a, am, b, bm, seg, 500.0, 0.8),
                                     50)}
    print(json.dumps(out))
    return 0 if all(v.get("exact", True) for v in out.values() if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
