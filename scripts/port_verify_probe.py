"""A short probe of the port's verification cost on the card: builds the
kernels, ingests the bench workload (2 agents x 128 KF) with place
recognition deferred, times 20 candidate verifications of agent 0's map
(dispatch, then fetch), one pose-graph solve (10 x 100) and the whole
drain, and prints the loops and merges.

Usage, on the machine with the card: python scripts/port_verify_probe.py
"""

import os
import sys
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from covins_tpu_torch import cuda_build  # noqa: E402
from covins_tpu_torch.models.map_manager import MapManager  # noqa: E402
from covins_tpu_torch.models.session import AgentSession  # noqa: E402
from covins_tpu_torch.ops import bow, pgo  # noqa: E402
from covins_tpu_torch.utils.config import Config  # noqa: E402


def main():
    t0 = time.time()
    cuda_build.build_all()
    print("build s", time.time() - t0)
    world, streams = cs.build_streams(2, 128, 2000)
    windows = cs.make_windows(streams)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).cuda(), k=512,
                                 iters=4, generator=gen).cpu().numpy()
    cfg = Config(placerec_defer=True)
    mgr = MapManager(vocab, cfg)
    sessions = {c: AgentSession(c, mgr, cfg) for c in range(2)}
    for window in windows:
        for c, ms in window.items():
            sessions[c].ingest_many(ms)
    for mp in mgr.maps.values():
        mp.commit_landmark_attributes()
    torch.cuda.synchronize()
    mp, pr = mgr.map_of(0), sessions[0].placerec
    pr.finalize_verify(pr.dispatch_verify(mp, 40, mp, 10))  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    jobs = [pr.dispatch_verify(mp, 40 + i, mp, 10) for i in range(20)]
    t_dispatch = time.time() - t0
    for job in jobs:
        pr.finalize_verify(job)
    torch.cuda.synchronize()
    print("20 verifications: dispatch s", t_dispatch, "total s", time.time() - t0)
    mp.add_loop_constraint(100, 20, mp.kf_pose[0])
    g = mp.to_pose_graph()
    pgo.optimize_pose_graph(g, n_gn=1, n_cg=100)
    torch.cuda.synchronize()
    t0 = time.time()
    pgo.optimize_pose_graph(g, n_gn=10, n_cg=100)
    torch.cuda.synchronize()
    print("pgo 10x100 s", time.time() - t0, "edges", g.edge_i.shape[0])
    mp.loops.pop()
    t0 = time.time()
    for s in sessions.values():
        s.flush()
    torch.cuda.synchronize()
    print("drain s", time.time() - t0, "loops", mgr.n_loops, "merges", mgr.n_merges,
          "pgo", mgr.n_pgo)


if __name__ == "__main__":
    main()
