"""Count the PyTorch operations one COVINS loop verification issues in
`covins_tpu_torch`, by stage, on the CPU.  On the card each of them costs
the host a dispatch and the card a launch, so the count is what bounds the
drain (see PERF.md).

The bench workload's stream (2 agents x 128 KF, vocabulary 512) is
ingested with place recognition deferred, then one candidate pair of agent
0's map is verified under a `TorchDispatchMode` that counts every aten
operation (views included), in total and per stage.

Usage: python scripts/port_op_count.py [--query 40 --candidate 10]
"""

import argparse
import json
import os
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402
from covins_tpu_torch.models.map_manager import MapManager  # noqa: E402
from covins_tpu_torch.models.session import AgentSession  # noqa: E402
from covins_tpu_torch.ops import bow, loopverify  # noqa: E402
from covins_tpu_torch.utils.config import Config  # noqa: E402


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", type=int, default=40)
    ap.add_argument("--candidate", type=int, default=10)
    args = ap.parse_args()
    torch.set_num_threads(1)
    world, streams = cs.build_streams(2, 128, 2000)
    windows = cs.make_windows(streams)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs), k=512, iters=4,
                                 generator=torch.Generator().manual_seed(cs.SEED)).numpy()
    cfg = Config(placerec_defer=True)
    mgr = MapManager(vocab, cfg, device="cpu")
    sessions = {c: AgentSession(c, mgr, cfg) for c in range(2)}
    for window in windows:
        for c, ms in window.items():
            sessions[c].ingest_many(ms)
    for mp in mgr.maps.values():
        mp.commit_landmark_attributes()

    counter = OpCounter()
    per_stage = Counter()
    stages = [(loopverify.relpose, "optimize_relative_pose"),
              (loopverify.pnp, "absolute_pose_ransac"),
              (loopverify.cam_mod, "back_project3"),
              (loopverify, "project_match_core"),
              (loopverify.d_ops, "hamming_mutual_nn")]
    saved = []
    for mod, name in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _name=name, **kw):
            n0 = counter.n
            out = _fn(*a, **kw)
            per_stage[_name] += counter.n - n0
            return out
        setattr(mod, name, counted)
    try:
        mp = mgr.map_of(0)
        with counter:
            sessions[0].placerec.dispatch_verify(mp, args.query, mp, args.candidate)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(json.dumps({"pair": [args.query, args.candidate],
                      "ops_per_verification": counter.n, "by_stage": per_stage}))


if __name__ == "__main__":
    main()
