"""How far rounding alone moves GBA's outlier pruning on the merged bench
map, on the CPU: the evidence for `chip_smoke.py` phase 6's check of the
pruned observations.

The bench workload (2 agents x 128 KF, vocabulary 512 trained on the CPU)
runs through the port on the CPU until its two maps are merged; then the
merged map's round 1 of `MapManager.run_gba` (5 Huber steps of 60 PCG
iterations) and the pruning at `th_gba_outlier_global` run on the map, on
a copy with its landmark positions moved by one ulp, on a copy with its
keyframe poses moved by one ulp, and on the map with 1 torch thread
instead of 4.  Printed per variant: the pruned count, how many pruning
decisions differ from the map's, the largest change of the round-1 states
and of the outlier norms, and the distance of the map's norms closest to
the threshold.

Usage: python scripts/port_gba_prune_sensitivity.py  (a few minutes, CPU)
"""

import copy
import json
import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from covins_tpu_torch.ops import bow, gba  # noqa: E402


def round1(mp, threshold):
    """Round 1 of run_gba on ``mp`` and the pruning after it: (states,
    outlier norms, pruned mask, live mask), numpy."""
    p = mp.to_gba_problem()
    graph = gba.obs_graph(p)
    st, _ = gba._gba_rounds(p, graph, 5, 60, 1e-4, False, 2.447)
    p1 = gba._with_state(p, st)
    norms, valid = gba.reproj_blocks(p1, graph, 0.0, "outlier")
    keep = p1.obs_mask & valid & (norms < threshold)
    return ([x.numpy() for x in st], norms.numpy(), (p1.obs_mask & ~keep).numpy(),
            p1.obs_mask.numpy())


def main():
    torch.set_num_threads(cs.CPU_THREADS)
    world, streams = cs.build_streams(2, 128, 2000)
    windows = cs.make_windows(streams)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs), k=512, iters=4,
                                 generator=torch.Generator().manual_seed(cs.SEED)).numpy()
    run = cs.run_slice(vocab, windows, 2, "cpu")
    mgr = run["mgr"]
    mp = mgr.maps[mgr.map_of_client[0]]
    mp.commit_landmark_attributes()
    th = mgr.cfg.th_gba_outlier_global
    base = round1(mp, th)
    gap = np.sort(np.abs(base[1][base[3]] - th))
    print(json.dumps({"variant": "map", "n_pruned": int(base[2].sum()),
                      "n_obs": int(base[3].sum()),
                      "closest_norm_gaps_to_threshold": gap[:5].tolist()}))

    def moved(name):
        m = copy.deepcopy(mp)
        setattr(m, name, np.nextafter(getattr(m, name), np.inf))
        return m

    for variant, m, threads in (("landmarks moved by one ulp", moved("lm_pos"), cs.CPU_THREADS),
                                ("poses moved by one ulp", moved("kf_pose"), cs.CPU_THREADS),
                                ("1 torch thread", mp, 1)):
        torch.set_num_threads(threads)
        r = round1(m, th)
        torch.set_num_threads(cs.CPU_THREADS)
        live = base[3]
        print(json.dumps({
            "variant": variant, "n_pruned": int(r[2].sum()),
            "pruned_differently": int((r[2] != base[2]).sum()),
            "round1_state_diff": max(float(np.abs(a - b).max()) for a, b in zip(r[0], base[0])),
            "norm_diff_max": float(np.abs(r[1] - base[1])[live].max()),
            "norm_diff_p99": float(np.quantile(np.abs(r[1] - base[1])[live], 0.99))}))


if __name__ == "__main__":
    main()
