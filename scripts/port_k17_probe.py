#!/usr/bin/env python3
"""Time K17 (the covisibility counts, `ops/covisibility.covis_weights_batch`)
of the PyTorch port on one CUDA card.

    python scripts/port_k17_probe.py

Inputs from ``utils/synthetic.covis_scene`` (a seed): the server phase's
snapshot shape (152 live of 160 keyframes, 27,441 landmarks, 101,712
observations, a landmark seen by ``chip_smoke.SERVER_VIEWS`` keyframes),
the same with duplicated observations and repeated queries, a long session
(1,024 keyframes, 200,000 landmarks, 1,000,000 observations, every keyframe
queried), 64 rows of a 40,000-keyframe map (the instance that counts in
device memory), and the server shape's last query alone (what the
grouping of the observations costs before any row is counted).  Each
through ``chip_smoke.k17_case``: bit for bit with the plain version on the
card, one launch a call, the mean time between back-to-back calls, the
card's busy time per call, the bound, the plain version's time and the
float32 matmul yardstick's.  Prints the card's name and power limit, then
one JSON line per shape.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# (n_kf, n_lm, O, culled keyframes, edges, queries kept, views)
CASES = ((160, 27_441, 101_712, 8, False, None, "server"),
         (160, 27_441, 101_712, 8, True, None, "server"),
         (1024, 200_000, 1_000_000, 0, False, None, None),
         (40_000, 30_000, 120_000, 4, True, 64, None),
         (160, 27_441, 101_712, 8, False, 1, "server"))


def main():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("port_k17_probe: no CUDA card", file=sys.stderr)
        return 2
    from covins_tpu_torch.utils import synthetic

    print(smoke.card_line())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    for n_kf, n_lm, O, culled, edges, n_q, views in CASES:
        views = smoke.SERVER_VIEWS if views == "server" else views
        q, kf, lm, mask = synthetic.covis_scene(rng, n_kf, n_lm, O, culled, edges, views)
        if n_q is not None:
            q = np.concatenate([q[rng.choice(len(q) - 1, n_q - 1, replace=False)], q[-1:]])
        t = [torch.from_numpy(x).to(dev) for x in (q, kf, lm, mask)]
        r = smoke.k17_case(*t, n_kf, n_lm, reps=20, cpu=False)
        print(json.dumps({"views": views, "edges": edges, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
