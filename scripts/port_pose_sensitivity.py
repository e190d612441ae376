"""How far rounding alone moves the port's final poses on the bench
workload, on the CPU: the evidence for the card-against-CPU bounds of
`chip_smoke.py` (`LOOP_TOL`, `POSE_TOL`).

1. The full main path (2 agents x 128 KF, vocabulary 512, default
   `Config()` with `placerec_defer=True`) runs twice through
   `covins_tpu_torch` on the CPU, with 1 and with 4 torch threads: the
   same algorithm, sums taken in another order.  Prints whether loops,
   merges and accepted pairs agree, and the largest difference of the loop
   transforms and of the final poses.
2. The merged map's pose graph is solved as the drain solves it (10
   Gauss-Newton x 100 PCG steps), again with every edge measurement scaled
   by 1 + eps, and with 300 PCG steps: how much the solve amplifies a tiny
   change of its inputs, and how far it is from converged.

Usage: python scripts/port_pose_sensitivity.py  (a few minutes)
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from covins_tpu_torch.ops import bow, pgo  # noqa: E402


def main():
    world, streams = cs.build_streams(2, 128, 2000)
    windows = cs.make_windows(streams)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs), k=512, iters=4,
                                 generator=torch.Generator().manual_seed(cs.SEED)).numpy()
    runs = {}
    for threads in (1, 4):
        torch.set_num_threads(threads)
        runs[threads] = cs.run_slice(vocab, windows, 2, "cpu")
    a, b = runs[1], runs[4]
    oa, ob = cs.outcome(a), cs.outcome(b)
    ma, mb = list(a["mgr"].maps.values()), list(b["mgr"].maps.values())
    loop_diff = max(float(np.abs(la["T_12"] - lb["T_12"]).max())
                    for x, y in zip(ma, mb) for la, lb in zip(x.loops, y.loops))
    pose_diff = max(float(np.abs(x.kf_pose - y.kf_pose).max()) for x, y in zip(ma, mb))
    print(json.dumps({"threads": [1, 4], "same_outcome": oa == ob,
                      "loops": oa["loops"], "merges": oa["merges"],
                      "max_loop_T_diff": loop_diff, "max_pose_diff": pose_diff}))

    mgr, mp = a["mgr"], ma[0]
    cfg = mgr.cfg
    g = mp.to_pose_graph(wt_kf_R=cfg.wt_kf_R, wt_kf_T=cfg.wt_kf_T,
                         use_nbr_kfs=cfg.use_nbr_kfs, wt_kf_n1=cfg.wt_kf_n1,
                         wt_kf_n23=cfg.wt_kf_n23, wt_kf_n45=cfg.wt_kf_n45,
                         fix_optimized_kfs=cfg.pgo_fix_kfs_after_gba)
    cauchy = cfg.robust_loss_threshold if cfg.use_robust_loss else 0.0
    base, _ = pgo.optimize_pose_graph(g, n_gn=10, n_cg=100, cauchy_scale=cauchy)
    for eps in (1e-15, 1e-13, 1e-11):
        moved, _ = pgo.optimize_pose_graph(
            dataclasses.replace(g, edge_T=g.edge_T * (1 + eps)),
            n_gn=10, n_cg=100, cauchy_scale=cauchy)
        print(json.dumps({"edges": int(g.edge_i.shape[0]), "edge_T_scaled_by": 1 + eps,
                          "max_pose_diff": float((moved - base).abs().max())}))
    longer, _ = pgo.optimize_pose_graph(g, n_gn=10, n_cg=300, cauchy_scale=cauchy)
    print(json.dumps({"pcg_steps": [100, 300],
                      "max_pose_diff": float((longer - base).abs().max())}))


if __name__ == "__main__":
    main()
