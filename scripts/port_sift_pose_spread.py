#!/usr/bin/env python3
"""How far the card's and the CPU's runs of `chip_smoke.py`'s SIFT cell
end apart, and which part of the path moves them.

    python scripts/port_sift_pose_spread.py [--repeats 2] [--save FILE]
    (needs a CUDA card; ``--save`` writes the card's vocabulary and the
    CPU run's pose graphs with `torch.save`, for study on the CPU)

The cell is the smoke's: 2 agents x PHASE7_KF keyframes in the SIFT world,
the 512-word L2 vocabulary trained on the card, the first G_HEAD_WINDOWS
windows, COVINS-G over SIFT.  It runs

1. on the CPU with CPU_THREADS and with 1 torch thread (the CPU's own
   spread: the same algorithm, sums in another order);
2. on the card ``--repeats`` times as the smoke runs it, and ``--repeats``
   times under ``torch.use_deterministic_algorithms`` (the warnings name
   the operations that have no deterministic form);
3. every pose graph the CPU run solved, replayed from its recorded input on
   the CPU and on the card (as run, and deterministic): how far the solve
   alone moves poses when its input is the same.

Prints the card's name and power limit, then one JSON line per comparison:
the largest difference of the final keyframe poses and landmark positions
(the smoke's ``max_pose_diff``), and of the loop transforms.
"""

import argparse
import json
import os
import sys
import warnings

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from covins_tpu_torch import cuda_build  # noqa: E402
from covins_tpu_torch.ops import pgo  # noqa: E402


class PGORecorder:
    """Records each `pgo.optimize_pose_graph` call's graph (on the CPU)
    and its poses."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._fn = pgo.optimize_pose_graph

        def rec(g, *a, **kw):
            poses, cost = self._fn(g, *a, **kw)
            self.calls.append((pgo.PoseGraph(*(t.cpu() for t in
                                                (getattr(g, f) for f in g.__dataclass_fields__))),
                               a, kw, poses.cpu()))
            return poses, cost

        pgo.optimize_pose_graph = rec
        return self

    def __exit__(self, *exc):
        pgo.optimize_pose_graph = self._fn


def diffs(a, b):
    worst_loop = max((float(np.abs(la["T_12"] - lb["T_12"]).max())
                      for mid, am in a["mgr"].maps.items()
                      for la, lb in zip(am.loops, b["mgr"].maps[mid].loops)), default=0.0)
    return {"same_outcome": cs.outcome(a) == cs.outcome(b), "max_loop_T_diff": worst_loop,
            "max_pose_diff": cs.pose_diff(a, b)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_sift_pose_spread: no CUDA card available", file=sys.stderr)
        return 2
    print(cs.card_line())
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    vocab, windows = cs.sift_inputs(dev)
    head = windows[: cs.G_HEAD_WINDOWS]
    cfg = cs.G_SIFT.config

    with PGORecorder() as c_rec:
        cpu = cs.run_cpu(vocab, head, 2, **cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu1 = cs.run_slice(vocab, head, 2, "cpu", **cfg)
    finally:
        torch.set_num_threads(threads)
    print(json.dumps({"compare": f"cpu {cs.CPU_THREADS} threads vs 1", **diffs(cpu, cpu1),
                      "pgo_solves": len(c_rec.calls)}))
    if args.save:
        torch.save({"vocab": vocab, "pgo_calls": c_rec.calls}, args.save)

    runs = {}
    for det in (False, True):
        for i in range(args.repeats):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(det, warn_only=True)
                try:
                    runs[det, i] = cs.run_slice(vocab, head, 2, "cuda", **cfg)
                finally:
                    torch.use_deterministic_algorithms(False)
            tag = f"card{' deterministic' if det else ''} {i}"
            print(json.dumps({"compare": f"{tag} vs cpu", **diffs(runs[det, i], cpu)}))
            if det and i == 0:
                names = sorted({str(w.message).split(" does not have")[0]
                                for w in caught if "deterministic" in str(w.message)})
                print(json.dumps({"nondeterministic_ops_warned": names}))
        for i in range(1, args.repeats):
            print(json.dumps({"compare": f"card{' deterministic' if det else ''} {i} vs 0",
                              **diffs(runs[det, i], runs[det, 0])}))

    # the pose graph alone, on the CPU run's recorded inputs
    for k, (g, a, kw, poses) in enumerate(c_rec.calls):
        again, _ = pgo.optimize_pose_graph(g, *a, **kw)
        row = {"pgo_solve": k, "n_poses": int(g.poses.shape[0]),
               "n_edges": int(g.edge_i.shape[0]), "cpu_again_equal": bool(torch.equal(again, poses))}
        gd = pgo.PoseGraph(*(getattr(g, f).to(dev) for f in g.__dataclass_fields__))
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            try:
                p1 = pgo.optimize_pose_graph(gd, *a, **kw)[0].cpu()
                p2 = pgo.optimize_pose_graph(gd, *a, **kw)[0].cpu()
            finally:
                torch.use_deterministic_algorithms(False)
            key = "card_det" if det else "card"
            row[f"{key}_vs_cpu"] = float((p1 - poses).abs().max())
            row[f"{key}_vs_itself"] = float((p1 - p2).abs().max())
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
