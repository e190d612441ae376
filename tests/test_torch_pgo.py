"""The port's pose-graph snapshot and solve against the JAX package.

Both packages ingest the same drifting synthetic stream (22 keyframes,
pose drift 0.05), record the same loop constraint (the ground-truth
relative pose of keyframes 19 and 5) and build their pose graphs with
`Map.to_pose_graph` seeded by the loop-corrected poses.  Tolerances: the
graph's edges, measurements and weights exactly (host numpy in both); the
corrected seed to 1e-12; the optimised poses after 10 Gauss-Newton x 100
PCG steps to 1e-8 (float64, sums in another order: the reference's
scatter-adds against the port's index_add and, on the card, K7's fixed
per-node order); the written-back map to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import pgo as ref_pgo
from covins_tpu.utils import geometry as ref_geo
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.ops import pgo
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils.config import Config

CFG = dict(placerec_active=False, activate_lm_culling=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def managers():
    world = SyntheticWorld.create(n_landmarks=500, seed=5)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs),
                                                k=64, iters=3))
    agent = SyntheticAgent(world, 0, n_keyframes=22, pose_drift=0.05)
    msgs = list(agent.messages())
    out = []
    for ref in (True, False):
        cfg = (RefConfig if ref else Config)(**CFG)
        mgr = RefManager(vocab, cfg) if ref else MapManager(vocab, cfg, device="cpu")
        s = (RefSession if ref else AgentSession)(0, mgr, cfg)
        s.ingest_many(msgs if ref else messages_from_reference(msgs))
        s.flush()
        out.append(mgr)
    T_gt = np.asarray(ref_geo.pose_relative(jnp.asarray(agent.traj.poses[19]),
                                            jnp.asarray(agent.traj.poses[5])))
    return out[0], out[1], T_gt


_STATE = ("kf_pose", "lm_pos", "kf_vel", "kf_pose_optimized", "kf_is_loop")


@pytest.fixture
def fresh(managers):
    """The module's managers, with each map's solve state restored after
    the test."""
    ref_mgr, mgr, T_gt = managers
    maps = (ref_mgr.map_of(0), mgr.map_of(0))
    saved = [{k: getattr(m, k).copy() for k in _STATE} for m in maps]
    yield ref_mgr, mgr, T_gt
    for m, st in zip(maps, saved):
        for k, v in st.items():
            setattr(m, k, v)
        m.loops.clear()


@pytest.mark.parametrize("cauchy", [0.0, 0.5])
def test_pose_graph_solve_matches_reference(fresh, cauchy):
    ref_mgr, mgr, T_gt = fresh
    ref_mp, mp = ref_mgr.map_of(0), mgr.map_of(0)
    ref_seed = ref_mgr._corrected_poses(ref_mp, 19, 5, T_gt)
    seed = mgr._corrected_poses(mp, 19, 5, T_gt)
    np.testing.assert_allclose(seed, ref_seed, rtol=0, atol=1e-12)

    ref_mp.add_loop_constraint(19, 5, T_gt)
    mp.add_loop_constraint(19, 5, T_gt)
    rg = ref_mp.to_pose_graph(poses_init=ref_seed)
    g = mp.to_pose_graph(poses_init=seed)
    ne = int(np.asarray(rg.edge_mask).sum())
    assert g.edge_i.shape == (ne,)
    for name in ("edge_i", "edge_j", "edge_T", "edge_sqrt_info", "edge_is_loop"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(rg, name))[:ne], err_msg=name)
    n = mp.n_kf
    for name in ("pose_mask", "fixed"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(rg, name))[:n], err_msg=name)
    np.testing.assert_allclose(g.poses.numpy(), np.asarray(rg.poses)[:n],
                               rtol=0, atol=1e-12)

    rp, rc = ref_pgo.optimize_pose_graph(rg, n_gn=10, n_cg=100, cauchy_scale=cauchy)
    p, c = pgo.optimize_pose_graph(g, n_gn=10, n_cg=100, cauchy_scale=cauchy)
    rp = np.asarray(rp)[:n]
    np.testing.assert_allclose(p.numpy(), rp, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(c), float(rc), rtol=1e-8)
    # the loop moved the map: the solve is not the identity
    assert np.abs(rp[:, 4:7] - seed[:, 4:7]).max() > 1e-3

    ref_mp.apply_pose_graph_result(np.asarray(rp))
    mp.apply_pose_graph_result(p.numpy())
    np.testing.assert_allclose(mp.kf_pose, ref_mp.kf_pose, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mp.lm_pos, ref_mp.lm_pos, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mp.kf_vel, ref_mp.kf_vel, rtol=0, atol=1e-8)


def test_matvec_plain_is_the_normal_matrix():
    """The matvec equals (J^T J) v * free + damping * v with J assembled
    densely from the edge blocks."""
    rng = np.random.default_rng(2)
    n, e = 9, 20
    ei = rng.integers(0, n, e)
    ej = (ei + rng.integers(1, n, e)) % n
    Ji, Jj = rng.normal(size=(e, 6, 6)), rng.normal(size=(e, 6, 6))
    free = (rng.random(n) > 0.2).astype(np.float64)
    v = rng.normal(size=(n, 6))
    J = np.zeros((6 * e, 6 * n))
    for k in range(e):
        J[6 * k:6 * k + 6, 6 * ei[k]:6 * ei[k] + 6] += Ji[k] * free[ei[k]]
        J[6 * k:6 * k + 6, 6 * ej[k]:6 * ej[k] + 6] += Jj[k] * free[ej[k]]
    want = (J.T @ J @ v.reshape(-1)).reshape(n, 6) + 1e-3 * v
    graph = pgo.matvec_graph(torch.tensor(ei), torch.tensor(ej), n)
    got = pgo.matvec(torch.tensor(v), torch.tensor(free), torch.tensor(Ji),
                     torch.tensor(Jj), graph, 1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # the CSR lists each node's i ends in edge order, then its j ends
    rowptr, entries = graph.rowptr.numpy(), graph.entries.numpy()
    for node in range(n):
        ent = entries[rowptr[node]:rowptr[node + 1]]
        want_ent = np.concatenate([np.where(ei == node)[0],
                                   e + np.where(ej == node)[0]])
        np.testing.assert_array_equal(ent, want_ent)
