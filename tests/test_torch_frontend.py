"""The port's front-end attachment against the JAX package's, on the CPU.

* CFS (`io/stream.py`): the port's writer gives the JAX writer's bytes for
  a calibration and keypoint, image and IMU frames; each package reads
  the other's stream; a bad magic raises in both.
* `FrontendWrapper` (`agents/frontend_adapter.py`): on the same CFS file
  every message field equals the JAX wrapper's, exactly: the motion
  threshold (`tests/test_frontend.py:66,88`'s frames), the keypoint
  branch, the image branch (ORB and undistortion by OpenCV, radtan and
  equidistant; skipped without OpenCV, as `tests/test_frontend.py:113`),
  and both of `replay`'s refusals.
* The replay into `AgentSession` in COVINS-G (`tests/test_frontend.py:126`'s
  scenario), port against JAX: keyframes, every map array (poses
  included: host numpy in both), the database and its queued scores, and
  each keyframe's candidates, all exactly.
* DBoW2 (`ops/dbow_import.py`): parsing the same file gives equal arrays;
  `flatten` is equal at budgets 4, 64 and 1024 on a ragged tree;
  `save_orb_vocabulary_text` writes the JAX package's bytes; `assign` (the
  plain version of K16 on the CPU) gives exactly the JAX package's ids and
  weights on a complete tree, a ragged one (leaves at depths 1-2, inner
  nodes without children, empty slots), tied children, a tree numbered out
  of order and masked rows; K16's child-block table (`child_blocks`)
  holds every inner node's children's rows and codes in slot order, and
  a descent written over it gives the plain version's words and weights.
* The CLI: a `.txt` vocabulary loads to the JAX CLI's flat matrix, and
  `run_stream` sends every keyframe into a CPU `CovinsServer`.
"""

import argparse
import dataclasses
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu import cli as ref_cli
from covins_tpu.agents.frontend_adapter import FrontendWrapper as RefWrapper
from covins_tpu.comm import messages as ref_msgs
from covins_tpu.io import stream as ref_cfs
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import dbow_import as ref_dbi
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch import cli
from covins_tpu_torch.agents.frontend_adapter import FrontendWrapper, run_stream
from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.comm.server import CovinsServer
from covins_tpu_torch.io import stream as cfs
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.ops import dbow_import as dbi
from covins_tpu_torch.state import hier_vocabulary_from_reference
from covins_tpu_torch.utils import npgeo
from covins_tpu_torch.utils.config import Config
from covins_tpu_torch.utils.synthetic import dbow_descriptors, dbow_tree

DEADLINE = 60.0
# the EuRoC cam0 radtan coefficients and a fisheye set for the image branch
DIST = {0: np.zeros(4), 1: np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
        2: np.asarray([-0.01, 0.002, -0.0005, 0.0001])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calib(mod, dist_model=0):
    return mod.VICalibration(
        T_s_c=npgeo.pose_identity(), cam_model=0, dist_model=dist_model,
        intrinsics=np.asarray([400.0, 400.0, 320.0, 240.0, 0.0]),
        dist=DIST[dist_model].copy(), img_w=640, img_h=480)


def _pose(x, yaw=0.0):
    q = npgeo.quat_exp(np.asarray([0.0, 0.0, yaw]))
    return np.concatenate([q, [x, 0.0, 0.0]])


def _frames(rng, n=4):
    """A keypoint frame with angles and velocity, an image frame, an IMU
    frame, then keypoint frames with IMU windows."""
    out = [dict(timestamp=0.1, T_w_s=_pose(0.0),
                keypoints=rng.uniform(0, 640, (40, 2)).astype(np.float32),
                descriptors=rng.integers(0, 256, (40, 32), dtype=np.uint8),
                keypoints_aors=rng.normal(size=(40, 4)).astype(np.float32),
                velocity=rng.normal(size=3)),
           dict(timestamp=0.2, T_w_s=_pose(1.0),
                image=rng.integers(0, 255, (48, 64), dtype=np.uint8))]
    for i in range(n):
        acc = rng.normal(size=(5, 3))
        out.append(dict(timestamp=0.3 + 0.1 * i, T_w_s=_pose(1.5 + 0.5 * i, 0.05 * i),
                        keypoints=rng.uniform(0, 640, (30, 2)).astype(np.float32),
                        descriptors=rng.integers(0, 256, (30, 32), dtype=np.uint8),
                        acc=acc, gyro=acc * 2, imu_dts=np.full(5, 0.01)))
    return out


def _write(mod, msg_mod, path, frames, calib=True, dist_model=0):
    with mod.StreamWriter(path) as w:
        if calib:
            w.write_calibration(_calib(msg_mod, dist_model))
        for f in frames:
            w.write_frame(**f)
    with open(path, "rb") as fh:
        return fh.read()


def _assert_equal(a, b, where="message"):
    """Dataclasses field by field (by name), arrays with their dtype, all
    exactly."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(b, a, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# ---------------------------------------------------------------- stream IO


def test_cfs_bytes_match_reference_and_cross_read(tmp_path):
    frames = _frames(np.random.default_rng(0))
    port = _write(cfs, msgs, str(tmp_path / "port.cfs"), frames)
    ref = _write(ref_cfs, ref_msgs, str(tmp_path / "ref.cfs"), frames)
    assert port == ref
    for reader, path in ((cfs, "ref.cfs"), (ref_cfs, "port.cfs")):
        got = list(reader.read_stream(str(tmp_path / path)))
        want = list(ref_cfs.read_stream(str(tmp_path / "ref.cfs")))
        assert [r["kind"] for r in got] == ["calib"] + ["frame"] * len(frames)
        for g, w in zip(got, want):
            _assert_equal(w, g, path)
    _assert_equal(ref_cfs.read_calibration(want[0]),
                  cfs.read_calibration(next(cfs.read_stream(str(tmp_path / "ref.cfs")))))


def test_cfs_bad_magic_raises_in_both(tmp_path):
    p = tmp_path / "bad.cfs"
    p.write_bytes(b"NOTASTREAM")
    for mod in (cfs, ref_cfs):
        with pytest.raises(ValueError, match="bad magic"):
            list(mod.read_stream(str(p)))


# ---------------------------------------------------------- FrontendWrapper


def _replay_both(path, **kw):
    ref = list(RefWrapper(None, client_id=2, **kw).replay(path))
    port = list(FrontendWrapper(None, client_id=2, **kw).replay(path))
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        _assert_equal(r, p)
    return port


def test_wrapper_motion_threshold_matches_reference(tmp_path):
    """`tests/test_frontend.py:66`'s frames (three big jumps, then a
    rotation alone) through a CFS file, and `:88`'s message schema."""
    rng = np.random.default_rng(1)
    kp = rng.uniform(0, 640, (30, 2)).astype(np.float32)
    de = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    xs = [0.0, 0.1, 0.2, 0.7, 0.75, 1.4, 1.45, 1.5]
    frames = [dict(timestamp=0.1 * i, T_w_s=_pose(x), keypoints=kp, descriptors=de)
              for i, x in enumerate(xs)]
    frames.append(dict(timestamp=9.0, T_w_s=_pose(1.4, yaw=0.3), keypoints=kp,
                       descriptors=de, acc=rng.normal(size=(4, 3)),
                       gyro=rng.normal(size=(4, 3)), imu_dts=np.full(4, 0.005)))
    path = str(tmp_path / "motion.cfs")
    _write(cfs, msgs, path, frames)
    out = _replay_both(path, kf_t_min=0.5, kf_r_min=0.2)
    assert [m.id for m in out] == [(0, 2), (1, 2), (2, 2), (3, 2)]
    assert out[-1].preintegration is not None and len(out[-1].preintegration.dts) == 4
    # process_frame and feed_imu called directly
    ws = [cls(_calib(mod), client_id=3) for cls, mod in ((RefWrapper, ref_msgs),
                                                         (FrontendWrapper, msgs))]
    for i, f in enumerate(frames):
        if i == 4:
            for w in ws:
                w.feed_imu(f["keypoints"][:3].astype(np.float64) * 0.01,
                           np.ones((3, 3)), np.full(3, 0.01))
        got = [w.process_frame(**{k: v for k, v in f.items()
                                  if k not in ("acc", "gyro", "imu_dts")}) for w in ws]
        assert (got[0] is None) == (got[1] is None)
        if got[0] is not None:
            _assert_equal(*got)


def test_wrapper_keypoint_stream_matches_reference(tmp_path):
    path = str(tmp_path / "kp.cfs")
    frames = [f for f in _frames(np.random.default_rng(2), n=6) if "image" not in f]
    _write(cfs, msgs, path, frames)
    out = _replay_both(path)
    assert len(out) == 7 and out[0].calibration is not None
    assert all(np.all(m.landmark_ids == -1) for m in out)


@pytest.mark.parametrize("dist_model", [0, 1, 2])
def test_wrapper_image_branch_matches_reference(tmp_path, dist_model):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    frames = []
    for i in range(3):
        img = rng.uniform(0, 255, (240, 320)).astype(np.uint8)
        frames.append(dict(timestamp=0.5 * i, T_w_s=_pose(0.5 * i),
                           image=cv2.GaussianBlur(img, (0, 0), 1.0)))
    path = str(tmp_path / "img.cfs")
    _write(cfs, msgs, path, frames, dist_model=dist_model)
    out = _replay_both(path, n_features=100, n_features_add=300)
    assert len(out) == 3
    for m in out:
        assert len(m.keypoints) > 8 and len(m.descriptors_add) >= len(m.descriptors)
        if dist_model:
            assert not np.array_equal(m.keypoints_undist, m.keypoints)


def test_wrapper_replay_refusals_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    kp = rng.uniform(0, 640, (10, 2)).astype(np.float32)
    de = rng.integers(0, 256, (10, 32), dtype=np.uint8)
    no_calib = str(tmp_path / "nocalib.cfs")
    _write(cfs, msgs, no_calib, [dict(timestamp=0.0, T_w_s=_pose(0.0), keypoints=kp,
                                      descriptors=de)], calib=False)
    no_gyro = str(tmp_path / "nogyro.cfs")
    _write(cfs, msgs, no_gyro, [dict(timestamp=0.0, T_w_s=_pose(0.0), keypoints=kp,
                                     descriptors=de, acc=np.zeros((3, 3)),
                                     imu_dts=np.full(3, 0.01))])
    for cls in (RefWrapper, FrontendWrapper):
        with pytest.raises(ValueError, match="calib"):
            list(cls(None, client_id=0).replay(no_calib))
        with pytest.raises(ValueError, match="gyro"):
            list(cls(None, client_id=0).replay(no_gyro))
    # a wrapper given a calibration replays a stream without one
    _assert_equal(next(RefWrapper(_calib(ref_msgs), 0).replay(no_calib)),
                  next(FrontendWrapper(_calib(msgs), 0).replay(no_calib)))


def test_replay_into_session_matches_reference(tmp_path, monkeypatch):
    """`tests/test_frontend.py:126`: CFS -> wrapper -> `AgentSession` in
    COVINS-G on the CPU, the port against the JAX package; every
    keyframe's retrieval candidates (`detect_loop`) recorded in both."""
    from covins_tpu.models.placerec import PlaceRecognition as RefPlaceRec
    from covins_tpu_torch.models.placerec import PlaceRecognition

    cands = {True: [], False: []}
    for ref, cls in ((True, RefPlaceRec), (False, PlaceRecognition)):
        def detect(self, *a, _fn=cls.detect_loop, _out=cands[ref], **kw):
            out = _fn(self, *a, **kw)
            _out.append([tuple(map(int, c)) for c in out])
            return out
        monkeypatch.setattr(cls, "detect_loop", detect)
    rng = np.random.default_rng(4)
    path = str(tmp_path / "fe.cfs")
    frames = [dict(timestamp=0.1 * i, T_w_s=_pose(0.5 * i),
                   keypoints=rng.uniform(0, 640, (30, 2)).astype(np.float32),
                   descriptors=rng.integers(0, 256, (30, 32), dtype=np.uint8))
              for i in range(8)]
    _write(cfs, msgs, path, frames)
    vocab = np.asarray(ref_bow.train_vocabulary(
        jnp.asarray(rng.integers(0, 256, (256, 32)).astype(np.uint8)), k=64, iters=2))
    runs = []
    for ref in (True, False):
        cfg = (RefConfig if ref else Config)(placerec_type="COVINS_G", start_after_kf=2,
                                             activate_lm_culling=False)
        kfs = list((RefWrapper if ref else FrontendWrapper)(None, 0).replay(path))
        mgr = RefManager(vocab, cfg) if ref else MapManager(vocab, cfg, device="cpu")
        sess = (RefSession if ref else AgentSession)(0, mgr, cfg)
        sess.ingest_many(kfs)
        queued = list(sess._pr_queue)
        sess.flush()
        runs.append((kfs, mgr, sess, queued))
    (r_kfs, r_mgr, r_sess, r_q), (kfs, mgr, sess, q) = runs
    for a, b in zip(r_kfs, kfs):
        _assert_equal(a, b)
    assert sess.stats == r_sess.stats and sess.stats["keyframes"] == 8
    assert cands[False] == cands[True] and len(cands[True]) == 8
    rm, mp = r_mgr.map_of(0), mgr.map_of(0)
    assert int(mp.kf_mask.sum()) == 8
    arrays = {k for k, v in vars(rm).items() if isinstance(v, np.ndarray)}
    assert arrays == {k for k, v in vars(mp).items() if isinstance(v, np.ndarray)}
    for name in sorted(arrays):
        np.testing.assert_array_equal(getattr(mp, name), getattr(rm, name), err_msg=name)
    rdb, db = r_mgr.database, mgr.database
    assert rdb.row_ids == db.row_ids and rdb.row_of == db.row_of
    np.testing.assert_array_equal(db._mask, rdb._mask)
    np.testing.assert_array_equal(db.db.numpy(), np.asarray(rdb._db))
    assert [k for k, _ in q] == [k for k, _ in r_q]
    for (_, rp), (_, pp) in zip(r_q, q):
        assert (rp is None) == (pp is None)
        if rp is not None:
            for name in ("valid", "common", "scores"):
                np.testing.assert_array_equal(np.asarray(pp[name]), np.asarray(rp[name]))


# ------------------------------------------------------------ DBoW2 import


def _tree_text(path, k, L, rng, ragged=False, ties=False):
    """A DBoW2 text vocabulary: a complete k-ary tree of depth L, or (with
    ``ragged``) one with 1-3 children a node, leaves at depth 1 and 2 and
    inner nodes left without children; with ``ties`` each node's children
    repeat one descriptor."""
    lines, level, nid = [], [0], 1
    for lvl in range(L):
        nxt = []
        for p in level:
            n = (3 if lvl == 0 else int(rng.integers(1, 4))) if ragged else k
            shared = rng.integers(0, 256, 32)
            for c in range(n):
                d = shared if ties and c % 2 else rng.integers(0, 256, 32)
                # ragged: the root's first child and each depth-1 node's
                # first child leaves, the root's second child an inner node
                # without children, and further such nodes at random
                leaf = lvl == L - 1 or (ragged and lvl < 2 and (
                    (lvl, c) == (0, 0) or (lvl == 1 and (c == 0 or rng.random() < 0.3))))
                childless = ragged and not leaf and ((lvl, c) == (0, 1) or rng.random() < 0.1)
                wt = float(rng.uniform(0.1, 2.0)) if leaf or childless else 0.0
                lines.append(f"{p} {int(leaf)} {' '.join(str(x) for x in d)} {wt}")
                if not leaf and not childless:
                    nxt.append(nid)
                nid += 1
        level = nxt
    with open(path, "w") as fh:
        fh.write(f"{k} {L} 0 0\n" + "\n".join(lines) + "\n")
    return str(path)


TREES = {"complete": dict(k=3, L=2), "ragged": dict(k=10, L=4, ragged=True),
         "ties": dict(k=4, L=3, ties=True), "orb_like": dict(k=10, L=3)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbow")
    return {name: _tree_text(d / f"{name}.txt", rng=np.random.default_rng(i), **kw)
            for i, (name, kw) in enumerate(TREES.items())}


def _arrays(voc):
    return {k: getattr(voc, k) for k in ("k", "L", "children", "node_desc", "node_weight",
                                         "leaf_word_id", "depth", "scoring", "weighting",
                                         "n_words")}


@pytest.mark.parametrize("name", list(TREES))
def test_dbow2_parse_flatten_save_match_reference(trees, tmp_path, name):
    ref = ref_dbi.load_orb_vocabulary_text(trees[name])
    voc = dbi.load_orb_vocabulary_text(trees[name])
    _assert_equal(_arrays(ref), _arrays(voc), name)
    _assert_equal(_arrays(voc), _arrays(hier_vocabulary_from_reference(ref)), name)
    for budget in (4, 64, 1024):
        _assert_equal(ref.flatten(max_words=budget), voc.flatten(max_words=budget),
                      f"{name} flatten {budget}")
    ref_dbi.save_orb_vocabulary_text(ref, str(tmp_path / "ref.txt"))
    dbi.save_orb_vocabulary_text(voc, str(tmp_path / "port.txt"))
    assert (tmp_path / "ref.txt").read_bytes() == (tmp_path / "port.txt").read_bytes()


def test_dbow2_ragged_tree_shapes(trees):
    voc = dbi.load_orb_vocabulary_text(trees["ragged"])
    is_leaf = voc.leaf_word_id >= 0
    assert set(voc.depth[is_leaf]) >= {1, 2}
    n_children = (voc.children >= 0).sum(1)
    assert ((n_children >= 1) & (n_children <= 3)).any() and (voc.children == -1).any()
    assert (~is_leaf & (n_children == 0) & (voc.depth > 0)).any()  # childless inner nodes


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("masked", [False, True])
def test_dbow2_assign_matches_reference(trees, name, masked):
    ref = ref_dbi.load_orb_vocabulary_text(trees[name])
    voc = hier_vocabulary_from_reference(ref)
    rng = np.random.default_rng(7)
    descs = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    # rows equal to tree nodes: distance 0 to a node, ties among equal children
    descs[:40] = voc.node_desc[rng.integers(1, len(voc.node_desc), 40)]
    mask = rng.random(300) < 0.7 if masked else None
    r_w, r_wt = ref.assign(descs, mask)
    before = dbi.dbow_descend.launches
    w, wt = voc.assign(descs, mask, device="cpu")
    assert dbi.dbow_descend.launches == before  # the plain version on the CPU
    assert w.dtype == torch.int32 and wt.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(r_w))
    np.testing.assert_array_equal(wt.numpy().view(np.int32), np.asarray(r_wt).view(np.int32))
    if masked:
        assert (w.numpy()[~mask] == -1).all() and (wt.numpy()[~mask] == 0).all()
    if name == "ragged":
        assert (w.numpy() == -1).sum() > (0 if not masked else (~mask).sum())


@pytest.mark.parametrize("kind,k,L", [("ragged", 10, 8), ("ties", 4, 4), ("complete", 2, 8),
                                      ("complete", 16, 2), ("ragged", 16, 4),
                                      ("shuffled", 10, 3)])
def test_dbow2_assign_on_seeded_trees_matches_reference(kind, k, L):
    """`utils/synthetic.dbow_tree`'s trees (as the card tests and the chip
    check build them; ragged ones with empty slots between children) in
    both packages' descents."""
    rng = np.random.default_rng(k * 100 + L)
    voc = dbow_tree(rng, k, L, kind)
    ref = ref_dbi.HierVocabulary(voc.k, voc.L, voc.children, voc.node_desc, voc.node_weight,
                                 voc.leaf_word_id, voc.depth)
    descs = dbow_descriptors(rng, voc, 500)
    mask = rng.random(500) < 0.8
    for m in (None, mask):
        r_w, r_wt = ref.assign(descs, m)
        w, wt = voc.assign(descs, m, device="cpu")
        np.testing.assert_array_equal(w.numpy(), np.asarray(r_w))
        np.testing.assert_array_equal(wt.numpy().view(np.int32),
                                      np.asarray(r_wt).view(np.int32))


def _descend_over_table(descs, blocks, L, node_weight, leaf_word_id):
    """K16's descent written over its child-block table in numpy: a level
    is one block's rows and codes; the least key (distance << 17 | slot),
    an empty slot counting NO_CHILD_DIST; a negative code ends the descent
    on node ~code, and a node of no child keeps it."""
    nxt, node_of = blocks.nxt.numpy(), blocks.node_of.numpy()
    rows = blocks.rows.numpy().reshape(nxt.shape + (32,))
    pop = np.asarray([bin(i).count("1") for i in range(256)])
    words, weights = [], []
    for d in descs:
        cur = blocks.root
        for _ in range(L):
            if cur < 0:
                break
            dist = np.where(nxt[cur] == dbi.EMPTY_SLOT, dbi.NO_CHILD_DIST,
                            pop[rows[cur] ^ d].sum(1))
            if dist.min() >= dbi.NO_CHILD_DIST:
                break
            cur = nxt[cur][np.argmin((dist << 17) | np.arange(len(dist)))]
        node = node_of[cur] if cur >= 0 else ~cur
        words.append(leaf_word_id[node])
        weights.append(node_weight[node])
    return np.asarray(words, np.int32), np.asarray(weights, np.float32)


@pytest.mark.parametrize("kind,k,L", [("complete", 10, 3), ("ragged", 10, 8), ("ragged", 40, 4),
                                      ("shuffled", 10, 3), ("shuffled", 3, 5), ("ties", 32, 2),
                                      ("complete", 1, 3), ("root_only", 4, 2)])
def test_dbow2_child_blocks_map_the_tree(kind, k, L):
    """K16's child-block table (`dbow_import.child_blocks`): every node
    reachable from the root that has a child has one inner number, level by
    level; each inner number's slots hold its children's rows and codes
    (the child's inner number, ~node for a child without children, an
    empty slot's code and zero row), in slot order, also where the node ids
    are shuffled; and the descent written over the table gives
    `dbow_descend_plain`'s ids and weight bits."""
    rng = np.random.default_rng(k * 10 + L)
    if kind == "root_only":
        voc = dbi.HierVocabulary(k, L, np.full((1, k), -1, np.int32),
                                 rng.integers(0, 256, (1, 32), dtype=np.uint8),
                                 np.float32([0.5]), np.int32([0]), np.int32([0]))
    else:
        voc = dbow_tree(rng, k, L, kind)
    blocks = dbi.child_blocks(voc.children, voc.node_desc)
    node_of, nxt = blocks.node_of.numpy(), blocks.nxt.numpy()
    rows = blocks.rows.numpy().reshape(len(node_of), k, 32)
    has_child = (voc.children >= 0).any(1)
    reach = {0}
    frontier = [0]
    while frontier:
        frontier = [int(c) for n in frontier for c in voc.children[n] if c >= 0
                    and c not in reach]
        reach |= set(frontier)
    assert sorted(node_of.tolist()) == sorted(n for n in reach if has_child[n])
    assert blocks.root == (0 if has_child[0] else -1)
    assert (np.diff(voc.depth[node_of]) >= 0).all()  # level by level: upper levels first
    inner_of = {int(n): i for i, n in enumerate(node_of)}
    for i, n in enumerate(node_of):
        for slot, c in enumerate(voc.children[n]):
            if c < 0:
                assert nxt[i, slot] == dbi.EMPTY_SLOT and not rows[i, slot].any()
                continue
            np.testing.assert_array_equal(rows[i, slot], voc.node_desc[c])
            assert nxt[i, slot] == (inner_of[int(c)] if has_child[c] else ~c)
    if kind == "shuffled":
        assert (np.diff(node_of) < 0).any()  # numbered by level, not by id
    descs = dbow_descriptors(rng, voc, 300)
    want_w, want_wt = dbi.dbow_descend_plain(torch.from_numpy(descs), None,
                                             *voc.tree_on(torch.device("cpu")), L)
    got_w, got_wt = _descend_over_table(descs, blocks, L, voc.node_weight, voc.leaf_word_id)
    np.testing.assert_array_equal(got_w, want_w.numpy())
    np.testing.assert_array_equal(got_wt.view(np.int32), want_wt.numpy().view(np.int32))


def test_dbow2_assign_edge_sizes(trees):
    ref = ref_dbi.load_orb_vocabulary_text(trees["complete"])
    voc = hier_vocabulary_from_reference(ref)
    for n in (0, 1):
        descs = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
        w, wt = voc.assign(torch.from_numpy(descs))  # a CPU tensor stays on the CPU
        assert w.shape == (n,) and wt.shape == (n,) and w.device.type == "cpu"
        if n:
            r_w, r_wt = ref.assign(descs)
            np.testing.assert_array_equal(w.numpy(), np.asarray(r_w))
            np.testing.assert_array_equal(wt.numpy(), np.asarray(r_wt))


def test_dbow2_descend_refuses_mixed_devices(trees):
    voc = dbi.load_orb_vocabulary_text(trees["complete"])
    tree = voc.tree_on(torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            voc.assign(np.zeros((2, 32), np.uint8))
    with pytest.raises(ValueError, match="outside"):
        bad = dbi.HierVocabulary(voc.k, voc.L, voc.children + 100, voc.node_desc,
                                 voc.node_weight, voc.leaf_word_id, voc.depth)
        bad.tree_on(torch.device("cpu"))
    assert tree[0].dtype == torch.int32 and tree[1].dtype == torch.uint8


# --------------------------------------------------------------------- CLI


def test_cli_text_vocabulary_matches_reference(trees, capsys):
    args = argparse.Namespace(vocab=trees["orb_like"], vocab_words=512)
    ref = ref_cli._load_or_make_vocab(args)
    ref_line = capsys.readouterr().out
    got = cli._load_or_make_vocab(args, torch.device("cpu"))
    assert capsys.readouterr().out == ref_line and "-> flat 1000" in ref_line
    assert got.dtype == np.uint8 and got.shape == (1000, 32)
    np.testing.assert_array_equal(got, ref)


def test_run_stream_into_cpu_server(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "s.cfs")
    frames = [f for f in _frames(rng, n=9) if "image" not in f]
    _write(cfs, msgs, path, frames)
    vocab = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = CovinsServer(vocab, Config(placerec_type="COVINS_G"), host="127.0.0.1",
                       port=port, output_dir=str(tmp_path / "out"), device="cpu")
    srv.start_background()
    try:
        n = run_stream(path, "127.0.0.1", port)
        assert n == len(frames)
        deadline = time.time() + DEADLINE
        while time.time() < deadline and not (
                srv.finished and sum(x.stats["keyframes"] for x in srv.sessions.values()) == n):
            time.sleep(0.1)
        assert sum(x.stats["keyframes"] for x in srv.sessions.values()) == n
    finally:
        srv.stop()
    assert not srv.errors, srv.errors
