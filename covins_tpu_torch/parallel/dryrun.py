"""The multi-device dry run: counterpart of the JAX package's
`__graft_entry__.py:121 dryrun_multichip`.

Four legs at the reference's sizes, each with its assert: one sharded GBA
step (32 keyframes, 1024 landmarks, 10 CG iterations) with a finite cost;
the sharded retrieval over (64 x world, 128) rows finding its query row;
the edge-sharded 32-pose chain converging to its ground truth; the
sharded Hamming k-NN over (64 x world, 256) rows finding its query at
distance 0.  The inputs are the port's own (`utils/synthetic`, numpy from
a seed).
"""

from __future__ import annotations

import numpy as np
import torch

from covins_tpu_torch.parallel import sharding as sh
from covins_tpu_torch.utils import geometry as geo
from covins_tpu_torch.utils import synthetic


def dryrun_multichip(mesh: sh.Mesh) -> dict:
    """Run the four legs on ``mesh`` (every rank calls it); returns the
    GBA cost, the retrieval's top index, the PGO error to the ground truth
    and the k-NN's first (index, distance)."""
    dev, world = mesh.device, mesh.world

    p, _, _ = synthetic.build_gba_problem(n_kf=32, n_lm=1024, seed=0, device=dev)
    shard = sh.shard_gba_problem(mesh, sh.pad_to_multiple(p, world))
    lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    _, _, cost = sh.gba_step_sharded(mesh, shard, shard.state(), lam, n_cg=10)
    cost = float(cost)
    assert np.isfinite(cost), f"GBA step produced non-finite cost {cost}"

    rng = np.random.default_rng(0)
    db = rng.random((64 * world, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    _, idx_k = sh.sharded_topk_scores(
        mesh, sh.shard_rows(mesh, db), sh.replicate(mesh, db[3]),
        sh.shard_rows(mesh, np.ones(len(db), bool)), k=5)
    top1 = int(idx_k[0])
    assert top1 == 3, "sharded retrieval failed to find the query row"

    g, gt = synthetic.chain_pose_graph(32, seed=1, device=dev)
    poses, _ = sh.optimize_pose_graph_sharded(mesh, sh.shard_pose_graph(mesh, g), n_gn=5,
                                              n_cg=200)
    pgo_err = float(geo.pose_boxminus(poses, gt).abs().max())
    assert pgo_err < 1e-4, f"sharded PGO did not converge: {pgo_err}"

    desc = rng.integers(0, 2, (64 * world, 256)).astype(np.float32) * 2 - 1
    dist_k, idx_kk = sh.sharded_hamming_knn(mesh, sh.shard_rows(mesh, desc),
                                            sh.replicate(mesh, desc[5:7]), k=2)
    knn = (int(idx_kk[0, 0]), int(dist_k[0, 0]))
    assert knn == (5, 0), f"sharded Hamming kNN failed: {knn}"

    print(f"dryrun_multichip({world}): GBA step cost={cost:.3f}, retrieval top1={top1}, "
          f"PGO err={pgo_err:.2e}, hamming-knn ok")
    return {"gba_cost": cost, "retrieval_top1": top1, "pgo_err": pgo_err, "knn": knn}
