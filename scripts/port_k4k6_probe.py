#!/usr/bin/env python3
"""Time stage 1 (K4, masked mutual-NN matching) and stage 2 (K6, P3P
RANSAC) of the PyTorch port's loop verification on one CUDA card, at the
main path's sizes.

    python scripts/port_k4k6_probe.py [--tree DIR] [--valid N]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``), so that two
versions can be compared in one run on one card, in turns; the inputs and
the timing come from this checkout's ``chip_smoke.py`` and
``covins_tpu_torch/utils/synthetic.py`` either way.  Prints the card's
name and power limit, then one JSON line with:

* K4: ``descriptors.hamming_mutual_nn`` at the verification's padded 1024
  x 1024 (chip_smoke's stage-1 scene: 420 and 390 valid rows and columns);
* stage 2 at 300 hypotheses (1200 roots) x 1024 correspondences, ``--valid``
  of them matched (``synthetic.p3p_scene``, Gumbel noise; by default 653,
  the most a stage-2 call of chip_smoke's bench drain has): the whole of
  what the stage does between stage 1's matches and its pose, i.e. for a
  tree whose ``absolute_pose_ransac`` takes stage 1's ``rows`` one call,
  and for one that does not the gather of the matched points, the match
  mask and the call (batched PyTorch solves and its scoring kernel);
* for each: the mean time between back-to-back calls (CUDA events, what a
  caller waits), the card's busy time per call (the calls queued behind a
  spin kernel, ``chip_smoke.busy_ms``; None where one call issues more
  operations than the card's queue holds), its kernel launches and the
  PyTorch operations one call issues;
* the ``-Xptxas -v`` register and spill lines of the sources.
"""

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--valid", type=int, default=653,
                    help="matched correspondences of the stage-2 scene")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k4k6_probe: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spec = importlib.util.spec_from_file_location(
        "synthetic_here", ROOT / "covins_tpu_torch" / "utils" / "synthetic.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import descriptors, pnp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    names = [n for n in ("hamming_mutual_nn", "p3p_score", "p3p_ransac")
             if n in cuda_build.SIGNATURES]
    logs = cuda_build.build_all(names)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    dev = torch.device("cuda", 0)

    def timed(fn, counted, reps, name):
        before = counted.launches
        fn()
        torch.cuda.synchronize()
        launches = counted.launches - before
        row = {"call_ms": smoke.cuda_ms(fn, reps), "busy_ms": smoke.busy_ms(fn, reps),
               "launches": launches, "ops_per_call": smoke.count_ops(fn)}
        print(json.dumps({name: row}), flush=True)
        return row

    out = {"tree": args.tree, "card": card, "ptxas": ptxas}
    rng = smoke.np.random.default_rng(smoke.SEED)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    a, am, b, bm = smoke._k4_inputs(rng, 1024, 1024, 420, 390, t)
    k4 = descriptors.hamming_mutual_nn
    out["k4"] = {**timed(lambda: k4(a, am, b, bm, 50.0), k4, 50, "k4"),
                 "shape": [1024, 1024]}

    (table, bear, mask), kw = scenes.p3p_scene(rng, 1024, args.valid, 300, dev)
    rows = kw.pop("rows")
    if "rows" in inspect.signature(pnp.absolute_pose_ransac).parameters:
        counted = pnp.absolute_pose_ransac

        def stage2():
            return pnp.absolute_pose_ransac(table, bear, mask, rows=rows, **kw)
    else:
        counted = pnp.p3p_score
        c = table.shape[0]

        def stage2():
            matched = (rows >= 0) & mask
            return pnp.absolute_pose_ransac(table[torch.clamp(rows, 0, c - 1).long()], bear,
                                            matched, **kw)
    out["stage2"] = {**timed(stage2, counted, 20, "stage2"), "shape": [1200, 1024],
                     "valid": args.valid}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
