"""The port's visual export against the JAX package's, on the same
synthetic stream: the counterparts of `tests/test_scenarios.py::
test_visual_export` and `::test_visual_export_product_wiring`.

Both packages ingest the JAX package's 12-keyframe stream
(`tests/test_scenarios.py`'s world, vocabulary and configuration, with
the JAX package's RANSAC draws handed to the port's place recognition)
and write their snapshots.  Compared: the map id, the agents, their
stamps and colours, the covisibility edges and the loops exactly; the
keyframe poses within 1e-4 and the landmark positions (rounded to 1e-4 by
the export) within 2e-4: `tests/test_torch_placerec.py` states why a
pose may move by 1e-4 across the packages.  The periodic `vis.active`
export of the port's server writes the same file as the JAX server's,
and so does its `snapshot` verb.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.comm.server import CovinsServer as RefServer
from covins_tpu.io import export as ref_export
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.comm.server import CovinsServer
from covins_tpu_torch.io import export
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.placerec import PlaceRecognition
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils.config import Config

POSE_TOL = 1e-4
# the export rounds positions to 4 decimals: a 1e-4 move may cross one step
LM_TOL = POSE_TOL + 1e-4
# tests/test_scenarios.py's _cfg
SCEN_CFG = dict(placerec_type="COVINS", start_after_kf=2, consecutive_loop_dist=6,
                min_loop_dist=6, exclude_kfs_with_id_less_than=2, cov_consistency_thres=2,
                matches_thres=12, matches_thres_merge=12, inliers_thres=12,
                ransac_min_inliers=5, perform_pgo=False, activate_lm_culling=False,
                gba_iteration_limit=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario():
    world = SyntheticWorld.create(n_landmarks=500, seed=2)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs), k=128, iters=4))
    stream = list(SyntheticAgent(world, 0, n_keyframes=12).messages())
    return vocab, stream


@pytest.fixture(autouse=True)
def jax_draws(monkeypatch):
    """The port's stage-2 Gumbel noise from the reference's keys: the
    agent's key split once per verification (`placerec.py:122-128`)."""
    keys = {}

    def next_gumbel(self, n_sets, n):
        key = keys.get(id(self), jax.random.PRNGKey(1000 * self.client_id))
        keys[id(self)], k = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.gumbel(k, (n_sets, n), jnp.float64)))
    monkeypatch.setattr(PlaceRecognition, "next_gumbel", next_gumbel)


def assert_snapshots_match(ref, got):
    assert got["map_id"] == ref["map_id"]
    assert got["agents"].keys() == ref["agents"].keys()
    for cid, r in ref["agents"].items():
        g = got["agents"][cid]
        assert g["color"] == r["color"] and g["stamps"] == r["stamps"]
        np.testing.assert_allclose(g["poses"], r["poses"], rtol=0, atol=POSE_TOL)
    assert got["covis_edges"] == ref["covis_edges"]
    assert [(lc["kf1"], lc["kf2"], lc["inter_agent"]) for lc in got["loops"]] == \
        [(lc["kf1"], lc["kf2"], lc["inter_agent"]) for lc in ref["loops"]]
    assert len(got["landmarks"]) == len(ref["landmarks"])
    np.testing.assert_allclose(got["landmarks"], ref["landmarks"], rtol=0, atol=LM_TOL)


def test_visual_export_matches_reference(scenario, tmp_path):
    vocab, stream = scenario
    snaps = []
    for ref in (True, False):
        cfg = (RefConfig if ref else Config)(**SCEN_CFG)
        mgr = RefManager(vocab, cfg) if ref else MapManager(vocab, cfg, device="cpu")
        sess = (RefSession if ref else AgentSession)(0, mgr, cfg)
        for m in (stream if ref else messages_from_reference(stream)):
            sess.ingest(m)
        sess.flush()
        path = str(tmp_path / f"snap_{ref}.json")
        (ref_export if ref else export).write_snapshot(mgr.map_of(0), path, covis_thres=5)
        with open(path) as fh:
            snaps.append(json.load(fh))
    ref_snap, snap = snaps
    assert_snapshots_match(ref_snap, snap)
    assert "0" in snap["agents"] and len(snap["agents"]["0"]["poses"]) == 12
    assert len(snap["covis_edges"]) > 0 and len(snap["landmarks"]) > 20


def test_visual_export_product_wiring_matches_reference(scenario, tmp_path):
    vocab, stream = scenario
    snaps = {}
    for ref in (True, False):
        out = tmp_path / ("ref" if ref else "port")
        cfg = (RefConfig if ref else Config)(**SCEN_CFG, vis_active=True,
                                             vis_snapshot_interval_kf=8)
        srv = (RefServer(vocab, cfg, output_dir=str(out)) if ref
               else CovinsServer(vocab, cfg, output_dir=str(out), device="cpu"))
        sess = (RefSession if ref else AgentSession)(0, srv.manager, cfg)
        srv.sessions[0] = sess
        sess.ingest_many(stream if ref else messages_from_reference(stream))
        sess.flush()
        # the periodic export path (the worker calls this after each window)
        srv._maybe_export_snapshots()
        mid = srv.manager.map_of(0).id
        periodic = out / f"vis_map{mid}.json"
        assert periodic.exists(), "vis.active periodic export did not write"
        reply = srv._admin({"verb": "snapshot", "map_id": mid, "path": str(out / "verb.json")})
        assert reply["ok"] and (out / "verb.json").exists()
        snaps[ref] = [json.loads(p.read_text()) for p in (periodic, out / "verb.json")]
    for ref_snap, snap in zip(snaps[True], snaps[False]):
        assert_snapshots_match(ref_snap, snap)
        assert len(snap["agents"]["0"]["poses"]) == 12
