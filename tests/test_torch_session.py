"""The port's ingest slice against the JAX package, end to end.

The JAX package's synthetic agents (2 agents x 12 KF over 300 landmarks)
produce the streams; `messages_from_reference` hands the same messages to
the port.  Both run `AgentSession.ingest_many` over 64-message windows with
``placerec_active=False`` and a 64-word vocabulary trained by the JAX
package, under both ``placerec_defer`` settings.  Tolerances:
integer/bool arrays and descriptors exactly; host float64 bookkeeping
(poses, positions) exactly, since both packages run the same numpy code;
device float64 attributes (normals, distance ranges) to 1e-12; float32
database rows and scores to rtol 1e-6 (the products sum in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.map_store import Map as RefMap
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.agents import synthetic_agent as port_agent
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils import synthetic
from covins_tpu_torch.utils.config import Config

N_AGENTS, N_KF, N_LM, WINDOW = 2, 12, 300, 64

FLOAT_ATTRS = ("lm_normal", "lm_dist_rng")  # computed on the device


AGENT_KW = dict(n_keyframes=N_KF, pose_drift=0.02)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's world and agents (their streams are made once)."""
    world = SyntheticWorld.create(n_landmarks=N_LM, seed=0)
    agents = [SyntheticAgent(world, cid, t0=5.0 * cid, **AGENT_KW)
              for cid in range(N_AGENTS)]
    return world, agents, [list(a.messages()) for a in agents]


@pytest.fixture(scope="module")
def streams(reference):
    world, _, ref = reference
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs),
                                                k=64, iters=3))
    return ref, [messages_from_reference(s) for s in ref], vocab


def _windows(streams):
    """Interleave per-client streams into windows of WINDOW messages."""
    out, cur = [], [0] * len(streams)
    while any(c < len(s) for c, s in zip(cur, streams)):
        win, budget = {}, WINDOW
        while budget > 0 and any(c < len(s) for c, s in zip(cur, streams)):
            for cid, s in enumerate(streams):
                if cur[cid] < len(s) and budget > 0:
                    win.setdefault(cid, []).append(s[cur[cid]])
                    cur[cid] += 1
                    budget -= 1
        out.append(win)
    return out


def _map_arrays(mp):
    return {k: v for k, v in vars(mp).items() if isinstance(v, np.ndarray)}


def assert_maps_equal(ref_mp, mp):
    ref, got = _map_arrays(ref_mp), _map_arrays(mp)
    assert set(ref) == set(got)
    assert (ref_mp.n_kf, ref_mp.n_lm, ref_mp.n_obs) == (mp.n_kf, mp.n_lm, mp.n_obs)
    for name, a in ref.items():
        b = got[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in FLOAT_ATTRS:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert ref_mp._kf_index == mp._kf_index
    assert ref_mp._lm_index == mp._lm_index
    assert ref_mp.associated_clients == mp.associated_clients


@pytest.fixture(scope="module")
def runs(streams):
    """(defer, ref) -> (manager, sessions, queued), each run once."""
    ref_streams, port_streams, vocab = streams
    cache = {}

    def get(defer, ref):
        if (defer, ref) not in cache:
            cache[defer, ref] = _run(ref_streams if ref else port_streams,
                                     vocab, defer, ref)
        return cache[defer, ref]
    return get


def _run(streams, vocab, defer, ref):
    cfg_cls, mgr_cls, ses_cls = ((RefConfig, RefManager, RefSession) if ref
                                 else (Config, MapManager, AgentSession))
    cfg = cfg_cls(placerec_active=False, placerec_defer=defer)
    mgr = mgr_cls(vocab, cfg) if ref else mgr_cls(vocab, cfg, device="cpu")
    sessions = {cid: ses_cls(cid, mgr, cfg) for cid in range(N_AGENTS)}
    for win in _windows(streams):
        for cid, ms in win.items():
            sessions[cid].ingest_many(ms)
    queued = [list(s._pr_queue) for s in sessions.values()]
    for s in sessions.values():
        s.flush()
    return mgr, sessions, queued


@pytest.mark.parametrize("defer", [False, True])
def test_slice_matches_reference(runs, defer):
    ref_mgr, ref_ses, ref_q = runs(defer, True)
    mgr, ses, q = runs(defer, False)

    assert sorted(ref_mgr.maps) == sorted(mgr.maps)
    for mid in ref_mgr.maps:
        assert_maps_equal(ref_mgr.maps[mid], mgr.maps[mid])
    for cid in range(N_AGENTS):
        assert ref_ses[cid].stats == ses[cid].stats
        assert ses[cid].stats["keyframes"] == N_KF
        assert ses[cid].placerec_backlog == 0

    rdb, db = ref_mgr.database, mgr.database
    assert rdb.n == db.n and rdb.row_ids == db.row_ids
    assert rdb.row_of == db.row_of
    np.testing.assert_array_equal(db._mask, rdb._mask)
    np.testing.assert_array_equal(db.row_kf, rdb.row_kf)
    np.testing.assert_array_equal(db.row_client, rdb.row_client)
    np.testing.assert_allclose(db.db.numpy(), np.asarray(rdb._db),
                               rtol=1e-6, atol=0)

    # the queued per-keyframe retrieval data of the deferred drain
    assert len(ref_q) == len(q)
    for rq, pq in zip(ref_q, q):
        assert [k for k, _ in rq] == [k for k, _ in pq]
        for (_, rp), (_, pp) in zip(rq, pq):
            assert (rp is None) == (pp is None)
            if rp is None:
                continue
            assert rp["row"] == pp["row"]
            np.testing.assert_array_equal(pp["valid"], rp["valid"])
            np.testing.assert_array_equal(np.asarray(pp["common"]),
                                          np.asarray(rp["common"]))
            np.testing.assert_allclose(np.asarray(pp["scores"]),
                                       np.asarray(rp["scores"]),
                                       rtol=1e-6, atol=1e-7)


def test_reference_checkpoint_loads_into_port(runs, tmp_path):
    ref_mgr, _, _ = runs(False, True)
    ref_mp = ref_mgr.maps[0]
    path = str(tmp_path / "map0.npz")
    ref_mp.save(path)
    got = Map.load(path, device="cpu")
    again = RefMap.load(path)
    assert_maps_equal(again, got)
    n = ref_mp.n_kf
    np.testing.assert_array_equal(got.kf_pose[:n], ref_mp.kf_pose[:n])
    np.testing.assert_array_equal(got.lm_desc[:ref_mp.n_lm],
                                  ref_mp.lm_desc[:ref_mp.n_lm])
    assert got.calib.keys() == ref_mp.calib.keys()
    # the port writes the same checkpoint back
    path2 = str(tmp_path / "map0_port.npz")
    got.save(path2)
    a, b = np.load(path), np.load(path2)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_placerec_active_is_refused(streams):
    """Place recognition over SIFT descriptors in the default COVINS mode is
    refused, as the reference runs SIFT in COVINS-G only; the message names
    the ways out, and both construct: COVINS-G over SIFT, and SIFT with
    place recognition off."""
    _, _, vocab = streams
    cfg = Config(placerec_active=True, feat_type="SIFT", desc_length=128)
    mgr = MapManager(vocab, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="placerec_active=False"):
        AgentSession(0, mgr, cfg)
    for ok in (Config(placerec_type="COVINS_G", feat_type="SIFT", desc_length=128),
               Config(placerec_active=False, feat_type="SIFT", desc_length=128)):
        AgentSession(0, MapManager(vocab, ok, device="cpu"), ok)


def test_trajectory_writers_match_reference(runs, tmp_path):
    ref_mgr, _, _ = runs(False, True)
    mgr, _, _ = runs(False, False)
    for fmt in ("TUM", "EUROC"):
        ref_mgr.maps[1].write_trajectories(str(tmp_path / "ref"), fmt=fmt)
        mgr.maps[1].write_trajectories(str(tmp_path / "port"), fmt=fmt)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "ref" / name).read_text() == \
            (tmp_path / "port" / name).read_text()


def test_database_stays_on_requested_device(streams):
    _, _, vocab = streams
    mgr = MapManager(vocab, Config(placerec_active=False), device="cpu")
    assert mgr.database.db.device == torch.device("cpu")


# --------------------------------------------------------------------------
# the port's stream generator against the JAX package's
#
# The trajectory is analytic, so the port's (torch.func.jacfwd) and the JAX
# package's (jax.jacfwd) agree to float64 rounding: 1e-9.  Given the JAX
# package's world (drawn with jax.random), the port's agents produce the
# same streams: ids, landmark ids and descriptors exactly, float64 poses
# and positions to 1e-9, float32 keypoints to 1e-4 px.


def test_trajectory_matches_reference(reference):
    _, agents, _ = reference
    for cid, ref in enumerate(agents):
        got = synthetic.generate(n_keyframes=N_KF, t0=5.0 * cid)
        for name in ("times", "poses", "vels", "imu_acc", "imu_gyro",
                     "imu_dts", "imu_mask"):
            np.testing.assert_allclose(getattr(got, name),
                                       np.asarray(getattr(ref.traj, name)),
                                       rtol=0, atol=1e-9, err_msg=name)


def _same(a, b, name):
    if isinstance(a, np.ndarray) and a.dtype.kind == "f":
        tol = 1e-4 if a.dtype == np.float32 else 1e-9
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=name)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
    else:
        assert a == b, name


def test_agent_streams_match_reference_on_the_same_world(reference):
    ref_world, _, ref_streams = reference
    world = port_agent.SyntheticWorld(
        np.asarray(ref_world.landmarks), np.asarray(ref_world.lm_descs),
        messages_from_reference(ref_world.calib))
    for cid, ref in enumerate(ref_streams):
        got = list(port_agent.SyntheticAgent(world, cid, t0=5.0 * cid,
                                             **AGENT_KW).messages())
        assert [type(m).__name__ for m in got] == \
            [type(m).__name__ for m in ref]
        assert sum(type(m).__name__ == "MsgLandmark" for m in got) > 20
        for i, (r, g) in enumerate(zip(ref, got)):
            _same(messages_from_reference(r), g, f"client{cid} msg{i}")
