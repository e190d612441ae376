#!/usr/bin/env python3
"""Time K17 (the covisibility counts, `ops/covisibility.covis_weights_batch`)
of the PyTorch port on one CUDA card.

    python scripts/port_k17_probe.py [--tree DIR] [--inputs FILE.npz ...]

Inputs from ``chip_smoke.k17_inputs`` (``utils/synthetic.covis_scene``, a
seed): every shape of ``chip_smoke.K17_SMOKE_CASES`` (the server phase's
snapshot shape, 152 live of 160 keyframes, 27,441 landmarks, 101,712
observations, a landmark seen by ``chip_smoke.SERVER_VIEWS`` keyframes, in
a map's keyframe runs and shuffled; the same with duplicated observations
and repeated queries; a long session of 1,024 keyframes, 200,000
landmarks and 1,000,000 observations, every keyframe queried; 64 rows of
a 40,000-keyframe map; 1,100 queries with keyframes repeated in other
bitmap words), the server shape's last query alone, and each ``--inputs``
file (``q``, ``kf``, ``lm``, ``mask``, ``n_kf``, ``n_lm``, as
``chip_smoke.py``'s phase "server" saves its snapshot's input in
``build/k17/server_snapshot.npz``).  Each through
``chip_smoke.k17_case``: bit for bit with the plain version on the card,
one launch a call, the mean time between back-to-back calls, the card's
busy time per call, the same launch with no observation (``floor_ms``),
the bound, the plain version's time and the float32 matmul yardstick's.

``--tree`` compares with the ``covins_tpu_torch`` of another checkout (for
example the parent commit unpacked with ``git archive`` into
``build/parent``): the whole run is made four times in turns, that tree,
this one, this one, that tree, each in a process of its own, on the same
inputs (the shapes, the inputs and the timing come from this checkout
either way).  Prints the card's name and power limit, then one JSON line
per shape and run, then (with ``--tree``) one line per shape with the four
runs' busy and floor times.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    return _module("smoke", ROOT / "chip_smoke.py")


def run(tree, inputs):
    """Every shape, then each saved input, on ``tree``'s K17: one JSON line
    each."""
    sys.path.insert(0, str(Path(tree).resolve()))
    smoke = _smoke()
    # this checkout's inputs, whichever tree is timed
    synthetic = _module("k17_synthetic", ROOT / "covins_tpu_torch" / "utils" / "synthetic.py")
    import torch

    if not torch.cuda.is_available():
        print("port_k17_probe: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    server = smoke.K17_SMOKE_CASES[0]
    # the server shape's last query alone, after every smoke shape
    for case in (*smoke.K17_SMOKE_CASES, server[:5] + (1,) + server[6:], *inputs):
        if isinstance(case, str):
            with np.load(case) as f:
                q, kf, lm, mask = (f[k] for k in ("q", "kf", "lm", "mask"))
                n_kf, n_lm = int(f["n_kf"]), int(f["n_lm"])
        else:
            q, kf, lm, mask = smoke.k17_inputs(rng, *case, synthetic=synthetic)
            n_kf, n_lm = case[:2]
        t = [torch.from_numpy(x).to(dev) for x in (q, kf, lm, mask)]
        r = smoke.k17_case(*t, n_kf, n_lm, reps=20, cpu=False)
        print(json.dumps({"tree": tree, "case": case if isinstance(case, str) else list(case),
                          **r}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--inputs", nargs="*", default=[])
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        return run(args.run, args.inputs)
    print(_smoke().card_line(), flush=True)
    trees = [str(ROOT)] if args.tree is None else [args.tree, str(ROOT), str(ROOT), args.tree]
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--run", tree, "--inputs",
                              *args.inputs], stdout=subprocess.PIPE, text=True)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            return out.returncode
        rows.append([json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")])
    if args.tree is not None:
        for turns in zip(*rows):
            print(json.dumps({"case": turns[0]["case"], "turns": trees,
                              "busy_ms": [r["busy_ms"] for r in turns],
                              "floor_ms": [r["floor_ms"] for r in turns],
                              "bound_ms": turns[0]["bound_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
