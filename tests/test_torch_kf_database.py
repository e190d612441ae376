"""Port's KeyframeDatabase against the JAX package's.

Tolerances: rows, ``valid`` masks and common-word counts exactly; scores
and database rows to rtol 1e-6 (float32 products summed in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.models.kf_database import KeyframeDatabase as RefDB
from covins_tpu.ops import bow as ref_bow
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.ops import bow
from covins_tpu_torch.state import database_from_reference


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(words), k=32,
                                                iters=2))

    def kf(n):  # descriptors near vocabulary words, 1-2 bits flipped
        d = vocab[rng.integers(0, 32, n)].copy()
        d[np.arange(n), rng.integers(0, 32, n)] ^= np.uint8(4)
        return d

    win1 = [((0, 0), kf(40)), ((1, 0), kf(25)), ((0, 1), kf(60))]
    # second window: a re-sent id and enough fresh rows to double cap 4
    win2 = [((2, 0), kf(33)), ((1, 0), win1[1][1]), ((1, 1), kf(7)),
            ((3, 0), kf(50))]
    return vocab, [win1, win2]


def _compare(ref_out, out):
    assert len(ref_out) == len(out)
    for r, p in zip(ref_out, out):
        assert r["row"] == p["row"]
        np.testing.assert_array_equal(p["valid"], r["valid"])
        np.testing.assert_array_equal(np.asarray(p["common"]),
                                      np.asarray(r["common"]))
        np.testing.assert_allclose(np.asarray(p["scores"]),
                                   np.asarray(r["scores"]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("lazy", [False, True])
def test_add_and_query_batch_matches_reference(data, lazy):
    vocab, windows = data
    ref, db = RefDB(vocab, capacity=4), KeyframeDatabase(vocab, capacity=4,
                                                         device="cpu")
    for win in windows:
        ids = [k for k, _ in win]
        descs = [d for _, d in win]
        _compare(ref.add_and_query_batch(ids, descs, lazy=lazy),
                 db.add_and_query_batch(ids, descs, lazy=lazy))
    assert db.db.shape == (8, 32) == tuple(ref._db.shape)  # doubled once
    assert db.n == ref.n == 6
    assert db.row_ids == ref.row_ids and db.row_of == ref.row_of
    np.testing.assert_array_equal(db._mask, ref._mask)
    np.testing.assert_allclose(db.db.numpy(), np.asarray(ref._db), rtol=1e-6,
                               atol=0)


def test_single_keyframe_paths_match_reference(data):
    vocab, windows = data
    ref, db = RefDB(vocab, capacity=2), KeyframeDatabase(vocab, capacity=2,
                                                         device="cpu")
    for kid, d in windows[0] + windows[1]:
        assert ref.add_keyframe(kid, d) == db.add_keyframe(kid, d)
    assert ref.erase_id((1, 0)) == db.erase_id((1, 0)) is True
    assert db.erase_id((9, 9)) is False
    np.testing.assert_allclose(db.db.numpy(), np.asarray(ref._db), rtol=1e-6,
                               atol=0)
    q = windows[1][0][1]
    r_s, r_c = ref.query(q, exclude_rows=np.asarray([0]))
    s, c = db.query(q, exclude_rows=np.asarray([0]))
    np.testing.assert_array_equal(c, r_c)
    np.testing.assert_allclose(s, r_s, rtol=1e-6, atol=1e-7)


def test_retrieval_helpers_match_reference(data):
    vocab, windows = data
    ref = RefDB(vocab, capacity=8)
    for win in windows:
        ref.add_and_query_batch([k for k, _ in win], [d for _, d in win])
    rows = np.array(ref._db)
    mask = ref._mask.copy()
    mask[1] = False
    q = np.array(ref.bow_vector(windows[1][0][1]))
    t = torch.from_numpy
    r_s = np.asarray(ref_bow.retrieval_scores(jnp.asarray(q), jnp.asarray(rows),
                                              jnp.asarray(mask)))
    s = bow.retrieval_scores(t(q), t(rows), t(mask))
    np.testing.assert_allclose(s.numpy(), r_s, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        bow.common_words(t(q), t(rows)).numpy(),
        np.asarray(ref_bow.common_words(jnp.asarray(q), jnp.asarray(rows))))
    r_top, r_idx = ref_bow.topk_candidates(jnp.asarray(r_s), 3)
    top, idx = bow.topk_candidates(t(r_s.copy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(top.numpy(), np.asarray(r_top))


def test_database_from_reference_state(data):
    vocab, windows = data
    ref = RefDB(vocab, capacity=4)
    for win in windows:
        ref.add_and_query_batch([k for k, _ in win], [d for _, d in win])
    ref.erase_id((0, 1))
    db = database_from_reference(np.asarray(ref._db), ref.row_ids, ref._mask,
                                 vocab, device="cpu")
    assert db.n == ref.n and db.row_of == ref.row_of
    np.testing.assert_array_equal(db.row_kf, ref.row_kf[: len(db.row_kf)])
    np.testing.assert_array_equal(db.db.numpy(), np.asarray(ref._db))
    # both keep inserting identically from the carried state
    d = windows[0][0][1]
    _compare(ref.add_and_query_batch([(7, 0)], [d]),
             db.add_and_query_batch([(7, 0)], [d]))
