"""Port's KeyframeDatabase against the JAX package's.

Tolerances: rows, ``valid`` masks and common-word counts exactly; scores
and database rows to rtol 1e-6 (float32 products summed in another
order); K3's plain version (`ops/bow.bow_insert_score_plain`) its vectors
and inserted rows exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.models.kf_database import KeyframeDatabase as RefDB
from covins_tpu.ops import bow as ref_bow
from covins_tpu_torch.models import kf_database
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.ops import bow, descriptors
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


def _window(rng, vocab, w, f_max):
    """A padded window of descriptors near vocabulary words (ragged counts,
    one keyframe without features) and its feature mask."""
    counts = rng.integers(1, f_max + 1, w)
    counts[w // 2] = 0
    descs = np.zeros((w, f_max, 32), np.uint8)
    mask = np.zeros((w, f_max), bool)
    for i, c in enumerate(counts):
        d = vocab[rng.integers(0, len(vocab), c)].copy()
        d[np.arange(c), rng.integers(0, 32, c)] ^= np.uint8(16)
        descs[i, :c], mask[i, :c] = d, True
    return descs, mask


@pytest.mark.parametrize("V", [64, 37])
@pytest.mark.parametrize("scored", [True, False])
def test_bow_insert_score_plain_matches_reference(V, scored):
    """K3's plain version against the JAX package's `_insert_and_score` on
    the same inputs: inserted rows and vectors exactly, common-word counts
    exactly, scores to rtol 1e-6 (another summation order).  With
    ``scored`` the window inserts rows inside the scored range [0, n);
    otherwise past it."""
    from covins_tpu.models.kf_database import _insert_and_score

    rng = np.random.default_rng(V + scored)
    vocab = rng.integers(0, 256, (V, 32), dtype=np.uint8)
    W, F, cap = 6, 40, 24
    descs, mask = _window(rng, vocab, W, F)
    db = (rng.random((cap, V)) * (rng.random((cap, V)) > 0.6)).astype(np.float32)
    n = 16
    dest = np.array([3, 9, cap, 0, 15, 12] if scored else [16, 17, cap, 20, 23, 18])
    r_db, r_scores, r_common = (np.asarray(x) for x in _insert_and_score(
        jnp.asarray(db), jnp.asarray(vocab), jnp.asarray(descs), jnp.asarray(mask),
        jnp.asarray(dest), "hamming"))
    t = torch.from_numpy
    words, _ = descriptors.hamming_argmin_plain(t(descs.reshape(-1, 32)), t(vocab),
                                                t(mask.reshape(-1)))
    words = words.reshape(W, F)
    p_db = t(db.copy())
    vecs, out = bow.bow_insert_score_plain(words, t(dest), p_db, n)
    np.testing.assert_array_equal(p_db.numpy(), r_db)
    np.testing.assert_array_equal(
        vecs.numpy(), np.asarray(ref_bow.bow_vectors_batch(jnp.asarray(words.numpy()), V)))
    np.testing.assert_array_equal(out[:, 1].view(torch.int32).numpy(), r_common[:, :n])
    np.testing.assert_allclose(out[:, 0].numpy(), r_scores[:, :n], rtol=1e-6, atol=1e-7)
    # the public function takes the plain version on the CPU
    again_db = t(db.copy())
    vecs2, out2 = bow.bow_insert_score(words, t(dest), again_db, n)
    assert torch.equal(vecs2, vecs) and torch.equal(out2, out)
    assert torch.equal(again_db, p_db)


def test_ordered_scores_order():
    """The plain score order is the kernel's: 32 lanes over zero-padded
    chunks in increasing order, then the butterfly, each step rounded."""
    rng = np.random.default_rng(5)
    q = rng.random((3, 70)).astype(np.float32)
    r = rng.random((4, 70)).astype(np.float32)
    got = bow.ordered_scores(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    pad = lambda x: np.pad(x, ((0, 0), (0, 26)))  # noqa: E731
    qp, rp = pad(q), pad(r)
    for i in range(3):
        for j in range(4):
            lanes = np.zeros(32, np.float32)
            for c in range(3):
                lanes = lanes + qp[i, 32 * c:32 * c + 32] * rp[j, 32 * c:32 * c + 32]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[np.arange(32) ^ off]
            assert got[i, j] == lanes[0]
    np.testing.assert_allclose(got, q @ r.T, rtol=1e-6)


@pytest.mark.parametrize("lazy", [False, True])
def test_packed_window_gives_the_unpacked_results(data, lazy):
    """The packed upload's slices (on the CPU: views of one uint8 buffer)
    give `add_and_query_batch` the results of the unpacked inputs: word
    assignment, vectors and insertion, scores against the inserted rows
    as one product, common-word counts as the binarised product."""
    vocab, windows = data
    db = KeyframeDatabase(vocab, capacity=8, device="cpu")
    for win in windows:
        ids, descs = [k for k, _ in win], [d for _, d in win]
        before = db.db.clone()
        n_before = db.n
        got = db.add_and_query_batch(ids, descs, lazy=lazy)
        w, f = len(ids), max(len(d) for d in descs)
        buf = np.zeros(kf_database.window_layout(w, f)[2], np.uint8)
        pd, pm, pdst = kf_database.window_views(buf, w, f)
        tv = kf_database.window_views(torch.from_numpy(buf), w, f)
        assert [x.data_ptr() for x in tv] == [
            buf.ctypes.data + o for o in (0, *kf_database.window_layout(w, f)[:2])]
        for i, d in enumerate(descs):
            pd[i, :len(d)], pm[i, :len(d)] = d, True
        pdst[:] = [g["row"] if g["row"] >= n_before else db.db.shape[0] for g in got]
        # the unpacked computation, as the port did it before the packing
        words, _ = descriptors.hamming_argmin(
            torch.from_numpy(pd.reshape(-1, 32).copy()), torch.tensor(vocab),
            torch.from_numpy(pm.reshape(-1).copy()))
        vecs = bow.bow_insert(words.reshape(w, f), torch.from_numpy(pdst.copy()), before)
        n = db.n
        scores = (vecs @ before.T)[:, :n]
        common = ((vecs > 0).float() @ (before > 0).float().T).to(torch.int32)[:, :n]
        assert torch.equal(before, db.db)
        for i, g in enumerate(got):
            np.testing.assert_array_equal(np.asarray(g["common"]), common[i].numpy())
            np.testing.assert_allclose(np.asarray(g["scores"]), scores[i].numpy(),
                                       rtol=1e-6, atol=1e-7)
