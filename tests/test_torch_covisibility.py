"""Keyframe redundancy (K15's plain version), covisibility counts and
keyframe culling against the JAX package.

Inputs: COOs from a numpy seed, and maps the JAX package builds from its
synthetic agents (place recognition off).  Expected, all exactly:
`redundancy_values_plain` bit for bit the JAX `redundancy_values` (its
float32 sums are taken in observation order, as the JAX package's CPU
scatter-add takes them); the integer covisibility counts equal; and
`erase_keyframe` / `remove_redundant_keyframes` on a map the JAX package
saved, loaded into both packages behind their own `MapManager` (so that
culled keyframes leave the retrieval database), remove the same keyframes
and leave equal masks, links, IMU windows, observation masks, landmark
anchors and database rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.map_store import Map as RefMap
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import covisibility as ref_cov
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.ops import covisibility as cov
from covins_tpu_torch.utils.config import Config

# (n_kf, n_lm, O, case): ragged sizes; a keyframe with no observation; no
# live observation; landmarks seen far more than six times; one
# observation; the five-agent map's size; observations sorted by keyframe
COO_CASES = [(37, 3001, 12345, "ragged"), (12, 200, 800, "kf_without_obs"),
             (9, 40, 700, "no_live_obs"), (6, 3, 500, "many_obs_per_lm"),
             (4, 7, 1, "one_obs"), (160, 40_000, 200_000, "large"),
             (25, 1200, 5000, "sorted")]


def _coo(n_kf, n_lm, O, case, seed=0):
    rng = np.random.default_rng(seed)
    kf = rng.integers(0, n_kf, O).astype(np.int32)
    if case == "kf_without_obs":
        kf[kf == 5] = 6
    if case == "sorted":
        kf = np.sort(kf)
    lm = rng.integers(0, n_lm, O).astype(np.int32)
    mask = (rng.random(O) < 0.8).astype(np.float32)
    if case == "no_live_obs":
        mask[:] = 0
    return kf, lm, mask


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n_kf,n_lm,O,case", COO_CASES, ids=[c[3] for c in COO_CASES])
def test_redundancy_values_bit_for_bit(n_kf, n_lm, O, case):
    kf, lm, mask = _coo(n_kf, n_lm, O, case)
    ref = ref_cov.redundancy_values(jnp.asarray(kf), jnp.asarray(lm), jnp.asarray(mask),
                                    n_kf=n_kf, n_lm=n_lm)
    got = cov.redundancy_values(torch.from_numpy(kf), torch.from_numpy(lm),
                                torch.from_numpy(mask), n_kf, n_lm)
    assert got.dtype == torch.float32 and got.shape == (n_kf,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    if case == "kf_without_obs":
        assert got[5] == 0
    if case == "many_obs_per_lm":
        assert set(np.unique(got.numpy())) <= {np.float32(1.0)}


@pytest.mark.parametrize("n_kf,n_lm,O,case", COO_CASES[:3], ids=[c[3] for c in COO_CASES[:3]])
def test_covisibility_counts(n_kf, n_lm, O, case):
    kf, lm, mask = _coo(n_kf, n_lm, O, case, seed=1)
    live = mask > 0
    q = np.arange(0, n_kf, 2, dtype=np.int32)
    ref = ref_cov.covis_weights_batch(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(lm),
                                      jnp.asarray(live), n_kf=n_kf, n_lm=n_lm)
    t = torch.from_numpy
    got = cov.covis_weights_batch(t(q), t(kf), t(lm), t(live), n_kf, n_lm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = cov.covis_weights_for(3, t(kf), t(lm), t(live), n_kf, n_lm)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref_cov.covis_weights_for(
        jnp.int32(3), jnp.asarray(kf), jnp.asarray(lm), jnp.asarray(live), n_kf=n_kf,
        n_lm=n_lm)))
    np.testing.assert_array_equal(
        cov.landmark_obs_counts(t(lm), t(mask), n_lm).numpy(),
        np.asarray(ref_cov.landmark_obs_counts(jnp.asarray(lm), jnp.asarray(mask), n_lm=n_lm)))


# ------------------------------------------------------------------- maps

@pytest.fixture(scope="module")
def world_vocab():
    world = SyntheticWorld.create(n_landmarks=400, seed=3)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs), k=64, iters=3))
    return world, vocab


@pytest.fixture(scope="module")
def five_agent_maps(world_vocab):
    """The JAX package's five agents (8 KF each, place recognition off)."""
    world, vocab = world_vocab
    cfg = RefConfig(placerec_active=False)
    mgr = RefManager(vocab, cfg)
    for cid in range(5):
        s = RefSession(cid, mgr, cfg)
        s.ingest_many(list(SyntheticAgent(world, cid, n_keyframes=8, t0=0.5 * cid).messages()))
        s.flush()
    return mgr


def test_redundancy_values_on_five_agent_maps(five_agent_maps):
    for mp in five_agent_maps.maps.values():
        o = mp.n_obs
        args = (mp.obs_kf[:o], mp.obs_lm[:o], mp.obs_mask[:o].astype(np.float32))
        ref = ref_cov.redundancy_values(*map(jnp.asarray, args), n_kf=mp.n_kf, n_lm=mp.n_lm)
        got = cov.redundancy_values(*map(torch.from_numpy, args), mp.n_kf, mp.n_lm)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.fixture(scope="module")
def saved_map(world_vocab, tmp_path_factory):
    """One agent's 20-keyframe map, built and saved by the JAX package."""
    world, vocab = world_vocab
    cfg = RefConfig(placerec_active=False)
    mgr = RefManager(vocab, cfg)
    s = RefSession(0, mgr, cfg)
    s.ingest_many(list(SyntheticAgent(world, 0, n_keyframes=20).messages()))
    s.flush()
    path = str(tmp_path_factory.mktemp("cull") / "map0.npz")
    mgr.map_of(0).save(path)
    return path


def _load_both(path, vocab):
    ref_mgr = RefManager(vocab, RefConfig(placerec_active=False))
    ref_mgr.register_map(RefMap.load(path))
    mgr = MapManager(vocab, Config(placerec_active=False), device="cpu")
    mgr.register_map(Map.load(path, device="cpu"))
    return ref_mgr, mgr


CULLED = ("kf_mask", "kf_pred", "kf_succ", "imu_acc", "imu_gyro", "imu_dts", "imu_n",
          "obs_mask", "lm_ref")


def _assert_culled_equal(ref_mgr, mgr):
    ref_mp, mp = next(iter(ref_mgr.maps.values())), next(iter(mgr.maps.values()))
    for name in CULLED:
        np.testing.assert_array_equal(getattr(mp, name), getattr(ref_mp, name), err_msg=name)
    assert mp._kf_index == ref_mp._kf_index
    rdb, db = ref_mgr.database, mgr.database
    assert db.row_of == rdb.row_of
    np.testing.assert_array_equal(db._mask, rdb._mask)


def test_erase_keyframe_matches_reference(saved_map, world_vocab):
    ref_mgr, mgr = _load_both(saved_map, world_vocab[1])
    for row in (7, 8, 0, 19):  # neighbours, the first and the last
        next(iter(ref_mgr.maps.values())).erase_keyframe(row)
        next(iter(mgr.maps.values())).erase_keyframe(row)
    _assert_culled_equal(ref_mgr, mgr)
    assert int(next(iter(mgr.maps.values())).kf_mask.sum()) == 16


@pytest.mark.parametrize("mode", ["threshold", "target"])
def test_remove_redundant_keyframes_matches_reference(saved_map, world_vocab, mode):
    ref_mgr, mgr = _load_both(saved_map, world_vocab[1])
    n_live = int(next(iter(mgr.maps.values())).kf_mask.sum())
    kw = (dict(threshold=0.9, max_time_dist=2.0) if mode == "threshold"
          else dict(max_time_dist=2.0, target_kf_count=n_live - 6))
    removed_ref = next(iter(ref_mgr.maps.values())).remove_redundant_keyframes(**kw)
    removed = next(iter(mgr.maps.values())).remove_redundant_keyframes(**kw)
    assert removed == removed_ref >= (6 if mode == "target" else 1)
    _assert_culled_equal(ref_mgr, mgr)
