"""The port's agent-facing server, client and CLI on the CPU, against the
JAX package's.

* Over TCP: the counterparts of `tests/test_comm.py` (end to end with the
  trajectory written; an agent that hangs up and resumes) and
  `tests/test_cereal_bridge.py` (a recorded reference-protocol stream
  through the cereal port), and the JAX package's own `AgentClient`
  streaming into the port's server, which builds the same map as an
  in-process session of the port.
* `CovinsServer._admin`, verb by verb, in both packages on the same maps:
  `loadmap` with place-recognition replay (`tests/test_scenarios.py:199`'s
  scenario: two 14-keyframe maps the JAX package built and saved), with
  the JAX package's RANSAC draws handed to the port
  (`PlaceRecognition.next_gumbel`): the same loops, merges and accepted
  pairs, poses within 1e-4 (`tests/test_torch_placerec.py` states why);
  then the merged map the JAX package saved, loaded by both: `stats` and
  `prunemap` equal, `snapshot` with equal covisibility edges and poses
  within 1e-4, `pgo` poses within 1e-8 (`tests/test_torch_pgo.py`'s map
  bound), `gba` from the same loaded state with the same pruned
  observations and within `tests/test_torch_gba.py`'s bound for a
  run_gba (10x the reference's own change under a one-ulp input change,
  measured there on its merged two-agent map, the same kind of map as
  this one), and `loadmap` refused once an agent registered.
* The CLI in subprocesses: a server on ``--device cpu`` with an agent and
  `admin stats`; a server with no ``--device`` fails without a card.

Every wait has a deadline of at most 60 s.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.comm.client import AgentClient as RefClient
from covins_tpu.comm.server import CovinsServer as RefServer
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.comm import cereal_bridge as cb
from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.comm.client import AgentClient
from covins_tpu_torch.comm.server import CovinsServer
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.placerec import PlaceRecognition
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60.0
# tests/test_comm.py's server configuration
COMM_CFG = dict(placerec_type="COVINS", start_after_kf=2, consecutive_loop_dist=6,
                min_loop_dist=6, exclude_kfs_with_id_less_than=2, cov_consistency_thres=2,
                matches_thres=12, matches_thres_merge=12, inliers_thres=12,
                ransac_min_inliers=5, perform_pgo=False, activate_lm_culling=False)
# tests/test_scenarios.py's (_cfg); keyframes 0.5 s apart, so culling may
# erase one only when a 1 s gap is allowed: the limit is raised to 2 s
SCEN_CFG = dict(COMM_CFG, perform_pgo=True, gba_iteration_limit=8,
                kf_culling_max_time_dist=2.0)
PGO_TOL = 1e-8
GBA_STATE_TOL, GBA_COST_RTOL = 10 * 6.79e-5, 10 * 5.04e-6
POSE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, what):
    deadline = time.time() + DEADLINE
    while time.time() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def comm_world():
    world = SyntheticWorld.create(n_landmarks=300, seed=1)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs), k=64, iters=3))
    return world, vocab


@pytest.fixture()
def server(comm_world, tmp_path):
    _, vocab = comm_world
    port = _free_port()
    srv = CovinsServer(vocab, Config(**COMM_CFG), host="127.0.0.1", port=port,
                       output_dir=str(tmp_path), device="cpu")
    srv.start_background()
    yield srv, port, str(tmp_path)
    srv.stop()
    assert not srv.errors, srv.errors


def _stream(world, cid, n_kf, **kw):
    return messages_from_reference(list(SyntheticAgent(world, cid, n_keyframes=n_kf,
                                                       **kw).messages()))


def test_server_end_to_end(server, comm_world):
    srv, port, out_dir = server
    client = AgentClient("127.0.0.1", port)
    assert client.client_id == 0
    for m in _stream(comm_world[0], client.client_id, 12):
        client.send(m)

    def done():
        stats = client.admin("stats")
        return stats if stats["result"]["maps"].get("0", {}).get("n_kf") == 12 else None
    stats = _wait(done, "12 keyframes")
    assert stats["result"]["maps"]["0"]["n_lm"] > 30
    client.finish()
    path = os.path.join(out_dir, "KF_0_ftum.csv")
    _wait(lambda: os.path.exists(path), "the trajectory file")
    assert len(open(path).read().strip().splitlines()) == 12


def test_agent_reconnect_resume(server, comm_world):
    srv, port, _ = server
    stream = _stream(comm_world[0], 0, 10)
    c1 = AgentClient("127.0.0.1", port)
    cid = c1.client_id
    for m in stream[: len(stream) // 2]:
        c1.send(m)
    c1.sock.close()  # abrupt hang-up, no FINISH
    time.sleep(0.5)
    c2 = AgentClient("127.0.0.1", port, resume_client_id=cid)
    assert c2.client_id == cid
    for m in stream:  # replay everything from the start
        c2.send(m)
    sess = _wait(lambda: (lambda s: s if s.get("keyframes") == 10 else None)(
        c2.admin("stats")["result"]["sessions"].get(str(cid), {})), "the resumed session")
    assert sess["duplicates"] > 0
    c2.finish()


def test_cereal_port_ingests_end_to_end(comm_world, tmp_path):
    world, vocab = comm_world
    stream = [m for m in _stream(world, 0, 6)
              if isinstance(m, (msgs.MsgKeyframe, msgs.MsgLandmark))]
    path = str(tmp_path / "ref_stream.bin")
    cb.record_stream(stream, path)
    port, cport = _free_port(), _free_port()
    srv = CovinsServer(vocab, Config(placerec_active=False), host="127.0.0.1", port=port,
                       cereal_port=cport, output_dir=str(tmp_path), device="cpu")
    srv.start_background()
    try:
        s = socket.create_connection(("127.0.0.1", cport), timeout=DEADLINE)
        hs = b""
        while len(hs) < cb.HEADER_BYTES:
            hs += s.recv(cb.HEADER_BYTES - len(hs))
        vals = struct.unpack(f">{cb.CONTAINER_ENTRIES * 5}I", hs)
        assert vals[0] == 1
        s.sendall(open(path, "rb").read())
        s.close()  # hang-up == finish
        sess = _wait(lambda: (lambda x: x if x and x.stats["keyframes"] >= 6 else None)(
            srv.sessions.get(vals[1])), "the cereal session")
        assert sess.stats["keyframes"] == 6 and sess.stats["landmarks"] > 0
        mp = srv.manager.map_of(vals[1])
        assert int(mp.kf_mask[: mp.n_kf].sum()) == 6
        assert int(mp.obs_mask[: mp.n_obs].sum()) > 0
    finally:
        srv.stop()
    assert not srv.errors, srv.errors


def test_reference_client_streams_into_port_server(comm_world, tmp_path):
    """The JAX package's client and messages; the port's server builds the
    map an in-process port session builds from the same messages."""
    world, vocab = comm_world
    cfg = Config(placerec_active=False)
    port = _free_port()
    srv = CovinsServer(vocab, cfg, host="127.0.0.1", port=port, output_dir=str(tmp_path),
                       device="cpu")
    srv.start_background()
    ref_stream = list(SyntheticAgent(world, 0, n_keyframes=10, send_updates=True).messages())
    try:
        client = RefClient("127.0.0.1", port)
        for m in ref_stream:
            client.send(m)
        _wait(lambda: client.admin("stats")["result"]["maps"].get("0", {}).get("n_kf") == 10,
              "10 keyframes from the reference client")
        client.finish()
        _wait(lambda: os.path.exists(tmp_path / "KF_0_ftum.csv"), "the trajectory file")
    finally:
        srv.stop()
    assert not srv.errors, srv.errors
    mgr = MapManager(vocab, cfg, device="cpu")
    sess = AgentSession(0, mgr, cfg)
    sess.ingest_many(messages_from_reference(ref_stream))
    sess.flush()
    got, want = srv.manager.map_of(0), mgr.map_of(0)
    assert (got.n_kf, got.n_lm, got.n_obs) == (want.n_kf, want.n_lm, want.n_obs)
    for name in ("kf_ids", "kf_pose", "kf_stamp", "lm_ids", "lm_pos", "obs_kf", "obs_lm",
                 "obs_mask", "descriptors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


# --------------------------------------------------------------- admin verbs

@pytest.fixture(scope="module")
def scen_world():
    world = SyntheticWorld.create(n_landmarks=500, seed=2)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs), k=128, iters=4))
    return world, vocab


@pytest.fixture(scope="module")
def saved_maps(scen_world, tmp_path_factory):
    """Two single-agent 14-keyframe maps built and saved by the JAX package
    (`tests/test_scenarios.py:199`)."""
    world, vocab = scen_world
    cfg = RefConfig(**dict(SCEN_CFG, perform_pgo=False))
    d = tmp_path_factory.mktemp("maps")
    paths = []
    for cid in (0, 1):
        mgr = RefManager(vocab, cfg)
        s = RefSession(cid, mgr, cfg)
        for m in SyntheticAgent(world, cid, n_keyframes=14, t0=3.0 * cid).messages():
            s.ingest(m)
        s.flush()
        paths.append(str(d / f"map{cid}.npz"))
        mgr.map_of(cid).save(paths[-1])
    return paths


def _servers(vocab, tmp):
    ref = RefServer(vocab, RefConfig(**SCEN_CFG), output_dir=str(tmp / "ref"))
    port = CovinsServer(vocab, Config(**SCEN_CFG), output_dir=str(tmp / "port"), device="cpu")
    return ref, port


def _jax_draws(monkeypatch):
    """The port's stage-2 Gumbel noise from the reference's keys: the
    agent's key split once per verification (`placerec.py:122-128`)."""
    keys = {}

    def next_gumbel(self, n_sets, n):
        key = keys.get(id(self), jax.random.PRNGKey(1000 * self.client_id))
        keys[id(self)], k = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.gumbel(k, (n_sets, n), jnp.float64)))
    monkeypatch.setattr(PlaceRecognition, "next_gumbel", next_gumbel)


def _loops(mp):
    return sorted((tuple(int(x) for x in mp.kf_ids[lc["kf1"]]),
                   tuple(int(x) for x in mp.kf_ids[lc["kf2"]])) for lc in mp.loops)


@pytest.fixture(scope="module")
def replayed(saved_maps, scen_world, tmp_path_factory):
    """Both packages' servers: loadmap of the first map, then of the second
    with placerec replay and PGO; the JAX package's merged map saved."""
    _, vocab = scen_world
    tmp = tmp_path_factory.mktemp("replay")
    ref, port = _servers(vocab, tmp)
    mp = pytest.MonkeyPatch()
    _jax_draws(mp)
    try:
        out = []
        for srv in (ref, port):
            first = srv._admin({"verb": "loadmap", "path": saved_maps[0]})
            second = srv._admin({"verb": "loadmap", "path": saved_maps[1],
                                 "placerec_replay": True, "run_pgo": True})
            out.append((first, second))
    finally:
        mp.undo()
    merged = str(tmp / "merged.npz")
    assert ref._admin({"verb": "savemap", "path": merged})["ok"]
    return ref, port, out, merged


def test_loadmap_placerec_replay_matches_reference(replayed):
    ref, port, ((r1, r2), (p1, p2)), _ = replayed
    assert r1 == p1 and r1["ok"] and r1["n_kf"] == 14
    assert json.loads(json.dumps(r2)) == json.loads(json.dumps(p2))
    assert p2["replay"]["merges"] >= 1, p2
    assert len(port.manager.maps) == len(ref.manager.maps) == 1
    (rmp,), (pmp,) = ref.manager.maps.values(), port.manager.maps.values()
    assert {0, 1} <= pmp.associated_clients
    assert _loops(pmp) == _loops(rmp)
    assert (port.manager.n_loops, port.manager.n_merges, port.manager.n_fused) == \
        (ref.manager.n_loops, ref.manager.n_merges, ref.manager.n_fused)
    assert (pmp.n_kf, pmp.n_lm, pmp.n_obs) == (rmp.n_kf, rmp.n_lm, rmp.n_obs)
    np.testing.assert_array_equal(pmp.kf_ids, rmp.kf_ids)
    np.testing.assert_array_equal(pmp.obs_mask, rmp.obs_mask)
    np.testing.assert_allclose(pmp.kf_pose, rmp.kf_pose, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(pmp.lm_pos, rmp.lm_pos, rtol=0, atol=POSE_TOL)


@pytest.fixture()
def loaded(replayed, scen_world, tmp_path):
    """Fresh servers of both packages that loaded the merged map."""
    ref, port = _servers(scen_world[1], tmp_path)
    for srv in (ref, port):
        assert srv._admin({"verb": "loadmap", "path": replayed[3]})["ok"]
    return ref, port


def _maps(ref, port):
    return next(iter(ref.manager.maps.values())), next(iter(port.manager.maps.values()))


def test_stats_and_prunemap_match_reference(loaded):
    ref, port = loaded
    stats = [json.loads(json.dumps(s._admin({"verb": "stats"}))) for s in (ref, port)]
    assert stats[0] == stats[1] and stats[1]["ok"]
    n_live = stats[1]["maps"]["0"]["n_kf"]
    cmd = {"verb": "prunemap", "max_num_kfs": n_live - 4}
    r, p = ref._admin(dict(cmd)), port._admin(dict(cmd))
    assert r == p and p["ok"] and p["removed"] == 4
    rmp, pmp = _maps(ref, port)
    for name in ("kf_mask", "kf_pred", "kf_succ", "imu_acc", "imu_gyro", "imu_dts",
                 "imu_n", "obs_mask", "lm_ref"):
        np.testing.assert_array_equal(getattr(pmp, name), getattr(rmp, name), err_msg=name)
    assert port.manager.database.row_of == ref.manager.database.row_of
    after = port._admin({"verb": "stats"})
    assert after["maps"][0]["n_kf"] == n_live - 4


def test_snapshot_and_savemap_match_reference(loaded, tmp_path):
    ref, port = loaded
    snaps = []
    for srv, tag in ((ref, "ref"), (port, "port")):
        out = srv._admin({"verb": "snapshot", "path": str(tmp_path / f"{tag}.json")})
        assert out["ok"]
        snaps.append(json.load(open(out["paths"][0])))
    rs, ps = snaps
    assert ps["covis_edges"] == rs["covis_edges"] and len(ps["covis_edges"]) > 0
    assert ps["agents"].keys() == rs["agents"].keys()
    for cid in rs["agents"]:
        np.testing.assert_allclose(ps["agents"][cid]["poses"], rs["agents"][cid]["poses"],
                                   rtol=0, atol=POSE_TOL)
    assert ps["loops"] == rs["loops"] and ps["landmarks"] == rs["landmarks"]
    out = port._admin({"verb": "savemap", "path": str(tmp_path / "port.npz")})
    assert out == {"ok": True, "path": str(tmp_path / "port.npz")}


def test_pgo_matches_reference(loaded):
    ref, port = loaded
    r, p = ref._admin({"verb": "pgo"}), port._admin({"verb": "pgo"})
    assert r == p == {"ok": True}
    rmp, pmp = _maps(ref, port)
    np.testing.assert_allclose(pmp.kf_pose, rmp.kf_pose, rtol=0, atol=PGO_TOL)
    np.testing.assert_allclose(pmp.lm_pos, rmp.lm_pos, rtol=0, atol=PGO_TOL)


def test_gba_matches_reference(loaded):
    ref, port = loaded
    r, p = ref._admin({"verb": "gba"}), port._admin({"verb": "gba"})
    assert p["ok"] and isinstance(p["final_cost"], float)
    assert p["n_pruned"] == r["n_pruned"] and p["time_budget_hit"] == r["time_budget_hit"]
    assert abs(p["final_cost"] - r["final_cost"]) <= GBA_COST_RTOL * abs(r["final_cost"])
    rmp, pmp = _maps(ref, port)
    np.testing.assert_array_equal(pmp.obs_mask, rmp.obs_mask)
    for name in ("kf_pose", "kf_vel", "kf_bias", "lm_pos"):
        diff = float(np.abs(getattr(pmp, name) - getattr(rmp, name)).max())
        assert diff <= GBA_STATE_TOL, (name, diff)


def test_admin_refusals_match_reference(loaded, replayed):
    ref, port = loaded
    # a dead map id names the live ones; an unknown verb; loadmap once an
    # agent registered
    for srv in (ref, port):
        with pytest.raises(KeyError, match=r"live: \[0\]"):
            srv._admin({"verb": "pgo", "map_id": 5})
    assert port._admin({"verb": "nope"}) == ref._admin({"verb": "nope"})
    ref.sessions[0] = RefSession(0, ref.manager, ref.cfg)
    port.sessions[0] = AgentSession(0, port.manager, port.cfg)
    cmd = {"verb": "loadmap", "path": replayed[3]}
    assert port._admin(dict(cmd)) == ref._admin(dict(cmd)) == \
        {"ok": False, "error": "agents already registered"}


# ----------------------------------------------------------------------- CLI

def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_cli_server_agent_admin(comm_world, tmp_path):
    _, vocab = comm_world
    np.savez(tmp_path / "vocab.npz", vocab=vocab)
    port = _free_port()
    cli = [sys.executable, "-m", "covins_tpu_torch"]
    server = subprocess.Popen(
        cli + ["server", "--device", "cpu", "--vocab", str(tmp_path / "vocab.npz"),
               "--port", str(port), "--output-dir", str(tmp_path / "out"), "--placerec-off"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        def up():
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                return True
            except OSError:
                assert server.poll() is None, server.communicate()[0]
                return False
        _wait(up, "the CLI server")
        agent = subprocess.run(cli + ["agent", "--keyframes", "8", "--port", str(port),
                                      "--landmarks", "300"],
                               cwd=ROOT, env=_env(), capture_output=True, text=True,
                               timeout=DEADLINE)
        assert agent.returncode == 0, agent.stderr
        # the readiness probe above took an id of its own
        cid = agent.stdout.split("client_id=")[1].split()[0]

        def stats():
            out = subprocess.run(cli + ["admin", "stats", "--port", str(port)], cwd=ROOT,
                                 env=_env(), capture_output=True, text=True,
                                 timeout=DEADLINE)
            assert out.returncode == 0, out.stderr
            reply = json.loads(out.stdout)
            return reply if reply["result"]["maps"].get("0", {}).get("n_kf") == 8 else None
        assert _wait(stats, "8 keyframes")["result"]["sessions"][cid]["keyframes"] == 8
    finally:
        server.terminate()
        out, _ = server.communicate(timeout=DEADLINE)
    assert "device=cpu" in out.splitlines()[0], out


def test_cli_refuses_without_a_card_or_an_unported_path(tmp_path):
    cli = [sys.executable, "-m", "covins_tpu_torch"]
    out = subprocess.run(cli + ["server", "--port", str(_free_port())], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr and "device='cpu'" in out.stderr
    for args in (["agent", "--euroc", str(tmp_path)], ["frontend", "--stream", "x"]):
        out = subprocess.run(cli + args, cwd=ROOT, env=_env(), capture_output=True,
                             text=True, timeout=DEADLINE)
        assert out.returncode != 0 and "A5" in out.stderr, out.stderr
