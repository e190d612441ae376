"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels are built
with nvcc at first use); without a card they skip.  On the machine with the
card, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have; this file imports neither JAX nor the JAX package.)

The shapes are small and ragged on purpose: row and column counts that do
not fill a block or a shared-memory tile, a single row, P = 1 and P = 32,
and a vocabulary large enough for the dynamic shared-memory path of K3.
Tolerances: K1 (binary tensor-core products; also ties across
vocabulary tiles, every row masked, distances 0 and 256) and K2's
descriptors exactly (integer results), K2's
normals and distance ranges (the whole attribute refresh in one launch)
bit for bit with its plain version; K3's word counts exactly
and its vectors bit for bit (integer counts, IEEE sqrt and division), and
as `bow_insert_score` (vectors, insertion, scores and common-word counts
in one launch) its scores bit for bit (one written summation order, no
FMA contraction) and its counts exactly; K4
exactly; K5, the whole of project-and-match in one launch, its matches
and distances exactly (its float64 prologue and gates are built without
FMA contraction and in the plain version's operation order, whose
separate operations round alike), with the camera models whose prologue
PyTorch computes, every landmark failing, and more features than shared
memory holds; K4 (stage 1 in one launch) also with ties, every row or
column masked and M != N; K6 (all of P3P RANSAC in one launch) its counts,
best pose and inlier mask exactly and every root's pose bit for bit; K7
to 1e-12 relative
and bit for bit between two launches; K8 and K10 to 1e-13 relative, K9
to 1e-13 of the sums of magnitudes behind each output (a landmark seen
once or twice has a nearly singular Hll, so its terms cancel), all
float64, built without FMA contraction, summing each landmark's
observations in the plain version's order (K9's keyframe sums in fixed
chunks of consecutive observations, then the chunks in order) and rounded
apart only where PyTorch's library products sum another way; bit for bit
between two launches; K8's validity and outlier decisions exactly, and
its cost of 1 and of 7 stacked states per state to 1e-13 relative, also
for the unified camera and equidistant distortion, whose projection
PyTorch hands it.  The
two PCG kernels (a Gauss-Newton step's whole loop per launch) within 10x
the largest of their plain loop's own changes under three rounding
differences (one ulp added to b, one ulp taken off, its dot products
summed in another order), at ragged sizes (two poses, five keyframes,
landmarks seen 0, 1 and 2 times, visual only, no loop edge, 0, 1 and full
iteration counts) and on a pose graph whose edges all weigh 100, and bit
for bit between two launches.  K11 (top-2 ratio matching per column
segment on K1's product, a block a row tile, segment and column part)
exactly, ragged, with ties inside a segment, across a shared-memory tile,
across column parts and across segments, every row masked, distances 0
and 256, and few rows over many segments; K12's scoring (one launch) its
counts, best hypotheses and inlier masks exactly at the COVINS-G path's
four shapes (six central RANSACs of 2000 poses over 1024 rays, one of 512
over 6144, the refine's single pose, the covariance's 60, counts only),
with NaN poses, hypothesis validity and batch entries padded to
different ray counts; K12's central 5-point RANSAC whole (one launch)
every pose bit for bit, its validity, the counts, the best pose, count
and inliers exactly, at the drain's 6 x 50 samples over 1024 rays from
noise and from given sets, ragged, and with degenerate pairs; all the
same across two launches.  K13 (the L2 word assignment) and K14 (the L2
top-2 ratio match per column segment) bit for bit with their plain
versions (one written float32 summation order, no FMA contraction): the
word ids, the minima, the indices and both distances, with ties inside
and across 64-column tiles, 256-column parts and segments, masked rows,
masked columns, a segment with one valid column, zero and large vectors,
row counts that are not a multiple of a tile and a vocabulary of 1024,
more near-equidistant columns than a row keeps candidates (the row
rescanned, and counted), distances one float32 ulp apart, a masked row
tile and segments of 0, 1 and 2 valid columns; their tensor-core filter
within its error bound on every pair;
K5's L2 metric (float32 SIFT descriptors, float64 distances) its matches
and distances exactly, as its Hamming metric.  K16 (the DBoW2
vocabulary-tree descent over the tree's child-block table, given or built
in the call) its word ids and weight bits exactly, with the
plain version on the card and on the CPU and across two launches: ragged
trees (empty slots among the children, leaves at depths 1 and 2, inner
nodes without children), tied children, k 1, 2, 3 and 16, masked rows, N 0 and
1, ORBvoc.txt's shape (k 10, L 6) at 6,480 and 65,536 descriptors, nodes
numbered out of order, and `HierVocabulary.assign` on the card.  K17 (the
covisibility counts) exactly, with the plain version on the card and on
the CPU and across two launches: the server's snapshot shape, a long
session of 1,000,000 observations, duplicated observations, repeated
queries and a query without a live observation, a single keyframe, maps
of 33,000 and 40,000 keyframes, no observation, the server's shape with
its observations shuffled, and 1,100 queries (two passes of the query
bitmap) with keyframes repeated in other bitmap words.
"""

import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import (bow, descriptors, epipolar, landmark_ops, pgo, pnp,
                                  projmatch)
from covins_tpu_torch.utils.synthetic import (central_5pt_scene, l2_match_scene,
                                              p3p_scene, project_match_scene,
                                              ratio_match_scene, ray_score_scene,
                                              stacked_states)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _desc(rng, *shape):
    return rng.integers(0, 256, shape + (32,), dtype=np.uint8)


@pytest.mark.parametrize("m,n", [(1, 1), (63, 257), (130, 512), (700, 1000)])
def test_hamming_argmin_matches_plain(dev, m, n):
    rng = np.random.default_rng(m * 7 + n)
    a, b = _desc(rng, m), _desc(rng, n)
    if n > 3:
        b[n - 1] = b[2]  # a tie across tiles: the lower index wins
        a[0] = b[2]
    mask = rng.random(m) > 0.3
    ta, tb, tm = (torch.from_numpy(x).to(dev) for x in (a, b, mask))
    before = descriptors.hamming_argmin.launches
    idx, dmin, dist = descriptors.hamming_argmin(ta, tb, tm, want_dist=True)
    assert descriptors.hamming_argmin.launches == before + 1
    ridx, rdmin, rdist = descriptors.hamming_argmin_plain(ta, tb, tm,
                                                          want_dist=True)
    assert torch.equal(dist, rdist)
    assert torch.equal(dist.cpu(), descriptors.hamming_distance_xor(
        torch.from_numpy(a), torch.from_numpy(b)))
    assert torch.equal(dmin, rdmin) and torch.equal(idx, ridx)
    idx2, dmin2 = descriptors.hamming_argmin(ta, tb)  # no row mask
    ridx2, _ = descriptors.hamming_argmin_plain(ta, tb)
    assert torch.equal(idx2, ridx2) and torch.equal(dmin2, rdmin)
    if n > 3 and mask[0]:
        assert int(idx[0]) == 2


def _k1_case(case):
    """(a, b, row mask) for the named edge case of K1."""
    rng = np.random.default_rng(len(case))
    if case == "ragged":  # M and N not multiples of 16 and 8
        return _desc(rng, 37), _desc(rng, 13), rng.random(37) > 0.3
    if case in ("two tiles", "five tiles"):  # N above one shared-memory tile
        n = 1025 if case == "two tiles" else 4100
        a, b = _desc(rng, 50), _desc(rng, n)
        b[n - 1] = b[3]  # a tie between the first and the last tile
        a[0] = b[3]
        a[1] = b[5]
        a[1, 0] ^= 1
        b[n - 2] = b[5]  # a tie at distance 1
        return a, b, np.ones(50, bool)
    if case == "all masked":
        return _desc(rng, 40), _desc(rng, 64), np.zeros(40, bool)
    if case == "zero and complement":
        a, b = _desc(rng, 20), _desc(rng, 9)
        a[2] = b[7]  # distance 0
        a[3] = ~b[4]  # distance 256 to word 4
        a[4] = 255  # all ones
        b[8] = 0  # all zeros: distance 256 to row 4
        b[6] = 255  # all ones: distance 0 to row 4
        return a, b, np.ones(20, bool)
    if case == "complement only":  # every distance 256
        b = _desc(rng, 1)
        return ~np.repeat(b, 3, axis=0), b, np.ones(3, bool)
    assert case == "one row"
    return _desc(rng, 1), _desc(rng, 300), np.ones(1, bool)


@pytest.mark.parametrize("case", ["ragged", "two tiles", "five tiles", "all masked",
                                  "zero and complement", "complement only", "one row"])
def test_hamming_argmin_edge_cases(dev, case):
    """K1 (binary tensor-core products) against its plain version exactly,
    and bit for bit across two launches."""
    a, b, mask = _k1_case(case)
    ta, tb, tm = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (a, b, mask))
    idx, dmin, dist = descriptors.hamming_argmin(ta, tb, tm, want_dist=True)
    ridx, rdmin, rdist = descriptors.hamming_argmin_plain(ta, tb, tm, want_dist=True)
    assert torch.equal(idx, ridx) and torch.equal(dmin, rdmin) and torch.equal(dist, rdist)
    idx2, dmin2 = descriptors.hamming_argmin(ta, tb, tm)
    assert torch.equal(idx2, idx) and torch.equal(dmin2, dmin)
    if case == "all masked":
        assert bool((idx == -1).all())
    if case in ("two tiles", "five tiles"):
        assert idx[:2].tolist() == [3, 5] and dmin[:2].tolist() == [0, 1]
    if case == "zero and complement":
        assert int(dmin[2]) == 0 and int(dist[3, 4]) == 256
        assert int(dist[4, 8]) == 256 and int(idx[4]) == 6 and int(dmin[4]) == 0
    if case == "complement only":
        assert dmin.tolist() == [256] * 3 and idx.tolist() == [0] * 3


def test_hamming_argmin_refuses_bad_inputs(dev):
    a = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    shifted = torch.zeros(8 * 32 + 8, dtype=torch.uint8, device=dev)[8:]
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(a[:, :16].contiguous(), a)  # not 32 bytes
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(shifted.view(8, 32), a)  # not 16-byte aligned
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(a, a, torch.ones(8, device=dev))
    with pytest.raises(RuntimeError):
        descriptors.hamming_argmin(a, a.cpu())


@pytest.mark.parametrize("L,P", [(1, 1), (37, 7), (300, 16), (65, 32)])
def test_representative_descriptors_match_plain(dev, L, P):
    rng = np.random.default_rng(L + P)
    d = _desc(rng, L, P)
    if P > 3:
        d[:, 3] = d[:, 1]  # duplicate observations: tied medians
    mask = rng.random((L, P)) > 0.4
    mask[0] = False  # no valid observation: row 0
    for i, nv in enumerate((1, 2, P), start=1):
        if i < L:
            mask[i] = False
            mask[i, :nv] = True
    td, tm = torch.from_numpy(d).to(dev), torch.from_numpy(mask).to(dev)
    before = landmark_ops.representative_descriptors.launches
    got = landmark_ops.representative_descriptors(td, tm)
    assert landmark_ops.representative_descriptors.launches == before + 1
    assert torch.equal(got, landmark_ops.representative_descriptors_plain(td, tm))
    assert torch.equal(got.cpu(), landmark_ops.representative_descriptors(
        torch.from_numpy(d), torch.from_numpy(mask)))


@pytest.mark.parametrize("L,P", [(1, 1), (4, 7), (37, 1), (300, 16), (65, 32), (1010, 16)])
def test_landmark_attributes_kernel_matches_plain(dev, L, P):
    """The whole refresh in one launch (K2) against its plain version on
    the card: descriptors exactly, normals and ranges bit for bit (the same
    float64 operations in the same order, FMA contraction off); against the
    CPU's plain version descriptors exactly, floats to 1e-12 relative (the
    card's pow may round the octave's power apart by an ulp).  The scene
    has a landmark with no valid observation, P = 1 and P = 32, tied
    medians and a camera centre on its landmark."""
    from covins_tpu_torch.utils.synthetic import refresh_scene

    host = landmark_ops.pack_refresh(*refresh_scene(np.random.default_rng(L + P), L, P))
    packed = host.to(dev)
    before = landmark_ops.landmark_attributes.launches
    got = landmark_ops.landmark_attributes(packed, L, P)
    assert landmark_ops.landmark_attributes.launches == before + 1
    assert torch.equal(got, landmark_ops.landmark_attributes(packed, L, P))
    ref = landmark_ops.landmark_attributes_plain(packed, L, P)
    g_desc, g_nrm, g_rng = landmark_ops.unpack_attributes(got, L)
    r_desc, r_nrm, r_rng = landmark_ops.unpack_attributes(ref, L)
    assert torch.equal(g_desc, r_desc)
    assert torch.equal(g_nrm, r_nrm) and torch.equal(g_rng, r_rng)
    c_desc, c_nrm, c_rng = landmark_ops.unpack_attributes(
        landmark_ops.landmark_attributes(host, L, P), L)
    assert torch.equal(g_desc.cpu(), c_desc)
    assert _rel(g_nrm, c_nrm.to(dev)) <= 1e-12 and _rel(g_rng, c_rng.to(dev)) <= 1e-12


def test_landmark_attributes_refuses_bad_inputs(dev):
    L, P = 8, 16
    total = landmark_ops.refresh_layout(L, P)[3]
    good = torch.zeros(total, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        landmark_ops.landmark_attributes(good[:-1], L, P)  # wrong size
    with pytest.raises(ValueError):
        landmark_ops.landmark_attributes(
            torch.zeros(total + 8, dtype=torch.uint8, device=dev)[8:], L, P)  # misaligned
    with pytest.raises(ValueError):
        landmark_ops.landmark_attributes(good, L, 33)


@pytest.mark.parametrize("W,F,V,cap", [(1, 1, 5, 1), (19, 300, 37, 8),
                                       (64, 1024, 512, 128),
                                       (3, 2000, 16384, 4)])
def test_bow_insert_matches_plain(dev, W, F, V, cap):
    rng = np.random.default_rng(W + F + V)
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    words[0, : F // 2] = V  # out of range: invalid, as -1 is
    if W > 2:
        words[2] = -1  # empty row: zero vector
    dest = rng.permutation(max(cap, W))[:W].astype(np.int64)
    dest[-1] = -1 if W > 1 else cap  # dropped
    tw, td = torch.from_numpy(words).to(dev), torch.from_numpy(dest).to(dev)
    db_k = torch.full((cap, V), 7.0, device=dev)
    db_p = db_k.clone()
    before = bow.bow_insert.launches
    vecs = bow.bow_insert(tw, td, db_k)
    assert bow.bow_insert.launches == before + 1
    ref = bow.bow_insert_plain(tw, td, db_p)
    valid = (words >= 0) & (words < V)
    counts = np.zeros((W, V), np.float32)
    np.add.at(counts, (np.nonzero(valid)[0], words[valid]), 1.0)
    norm = np.maximum(np.sqrt((counts * counts).sum(1)), 1e-12)[:, None]
    assert np.array_equal(np.rint(vecs.cpu().numpy() * norm), counts)
    assert torch.equal(vecs, ref)
    assert torch.equal(db_k, db_p)


@pytest.mark.parametrize("W,F,V,cap,n", [(12, 540, 512, 1024, 1000), (5, 100, 37, 16, 16),
                                         (7, 300, 100, 64, 20), (1, 1, 5, 1, 1),
                                         (3, 2000, 16384, 4, 4), (40, 64, 512, 128, 100)])
def test_bow_insert_score_matches_plain(dev, W, F, V, cap, n):
    """K3, the window's vectors, insertion, scores and common-word counts
    in one launch: vectors and rows exactly, scores bit for bit, counts
    exactly, and bit for bit across two launches.  Rows inserted in the
    launch lie inside the scored range [0, n) (scored by every window row),
    and where cap allows one also past n; n < cap and n = cap; V not a
    multiple of 32; a dropped destination and an empty window row; the
    last two cases hold more window rows than one group in shared memory."""
    rng = np.random.default_rng(W * F + V + n)
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    if W > 2:
        words[2] = -1  # empty row: zero vector
        words[1, : F // 2] = V  # out of range: invalid
    dest = rng.permutation(n)[:W].astype(np.int64)
    if W > 2:
        dest[0] = -1 if W % 2 else cap  # dropped
    if n + 2 <= cap and W > 3:
        dest[3] = n + 1  # inserted, not scored
    db = (rng.random((cap, V)) * (rng.random((cap, V)) > 0.5)).astype(np.float32)
    tw, td = torch.from_numpy(words).to(dev), torch.from_numpy(dest).to(dev)
    db_k, db_p = (torch.from_numpy(db).to(dev) for _ in range(2))
    if W == 40:
        assert W > bow.score_group(W, V)
    before = bow.bow_insert_score.launches
    vecs, out = bow.bow_insert_score(tw, td, db_k, n)
    assert bow.bow_insert_score.launches == before + 1
    rvecs, rout = bow.bow_insert_score_plain(tw, td, db_p, n)
    assert torch.equal(vecs, rvecs) and torch.equal(db_k, db_p)
    assert torch.equal(out[:, 0], rout[:, 0])
    assert torch.equal(out[:, 1].view(torch.int32), rout[:, 1].view(torch.int32))
    again = torch.from_numpy(db).to(dev)
    vecs2, out2 = bow.bow_insert_score(tw, td, again, n)
    assert torch.equal(vecs2, vecs) and torch.equal(out2, out) and torch.equal(again, db_k)
    # float64 products of the same vectors and rows, as a sanity bound
    rows = db_k[:n].double()
    np.testing.assert_allclose(out[:, 0].cpu().numpy(), (vecs.double() @ rows.T).cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    if W > 2:
        assert bool((out[2, 0] == 0).all()) and bool((out[2, 1] == 0).all())


def test_bow_insert_refuses_bad_inputs(dev):
    words = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    db = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int32, device=dev), db)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int64, device=dev),
                       db.double())
    with pytest.raises(ValueError):
        bow.bow_insert_score(words, torch.zeros(2, dtype=torch.int64, device=dev), db, 5)
    with pytest.raises(ValueError):
        bow.bow_insert_score(words.T, torch.zeros(4, dtype=torch.int64, device=dev), db, 2)


@pytest.mark.parametrize("m,n", [(1, 1), (5, 70), (300, 129), (1024, 1024)])
def test_hamming_mutual_nn_matches_plain(dev, m, n):
    rng = np.random.default_rng(m + 3 * n)
    a, b = _desc(rng, m), _desc(rng, n)
    k = min(m, n)
    a[: k // 2] = b[: k // 2]  # mutual pairs at distance 0
    if n > 4:
        b[n - 1] = b[0]  # a tied column: the lower index wins
    am, bm = rng.random(m) > 0.2, rng.random(n) > 0.2
    ta, tb, tam, tbm = (torch.from_numpy(x).to(dev) for x in (a, b, am, bm))
    before = descriptors.hamming_mutual_nn.launches
    got = descriptors.hamming_mutual_nn(ta, tam, tb, tbm, 50.0)
    assert descriptors.hamming_mutual_nn.launches == before + 1
    ref = descriptors.hamming_mutual_nn_plain(ta, tam, tb, tbm, 50.0)
    assert torch.equal(got, ref)
    cpu = descriptors.hamming_mutual_nn(*(torch.from_numpy(x) for x in (a, am, b, bm)),
                                        50.0)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("case", ["ties", "rows_masked", "cols_masked", "tall", "wide",
                                  "one_row", "one_col"])
def test_hamming_mutual_nn_edge_cases_match_plain(dev, case):
    """Stage 1 in one launch against its plain version, exactly: many
    equal distances (one descriptor repeated down rows and columns, so
    ties go to the lowest index on both sides), every row or every column
    masked, M != N at ragged sizes; one launch per call, equal results on
    relaunch."""
    rng = np.random.default_rng(len(case))
    m, n = {"tall": (1000, 77), "wide": (65, 3000), "one_row": (1, 200),
            "one_col": (300, 1)}.get(case, (333, 517))
    a, b = _desc(rng, m), _desc(rng, n)
    am, bm = rng.random(m) > 0.3, rng.random(n) > 0.3
    if case == "ties":
        a[::3] = a[0]
        b[::2] = a[0]
        b[1::4] = a[0] ^ 1
    a[: min(m, n) // 3] = b[: min(m, n) // 3]
    if case == "rows_masked":
        am[:] = False
    if case == "cols_masked":
        bm[:] = False
    ta, tb, tam, tbm = (torch.from_numpy(x).to(dev) for x in (a, b, am, bm))
    before = descriptors.hamming_mutual_nn.launches
    got = descriptors.hamming_mutual_nn(ta, tam, tb, tbm, 50.0)
    again = descriptors.hamming_mutual_nn(ta, tam, tb, tbm, 50.0)
    assert descriptors.hamming_mutual_nn.launches == before + 2
    ref = descriptors.hamming_mutual_nn_plain(ta, tam, tb, tbm, 50.0)
    assert torch.equal(got, ref) and torch.equal(got, again)
    if case in ("rows_masked", "cols_masked"):
        assert not bool((got >= 0).any())
    elif case not in ("one_row", "one_col"):
        assert int((got >= 0).sum()) > 0


# the scenes of chip_smoke's K5 checks: the camera whose prologue the kernel
# computes (pinhole without and with radtan distortion), with the view-angle
# gate, every landmark failing, and the camera models whose prologue the
# wrapper computes in PyTorch (the unified model, equidistant distortion)
K5_CASES = {"pinhole": dict(camera="pinhole"), "radtan_view_angle": dict(view_angle=True),
            "all_fail": dict(fail=True), "omni_given": dict(camera="omni"),
            "equidistant_given": dict(camera="equidistant"),
            # the L2 metric over float32 (SIFT) descriptors
            "sift": dict(sift=True), "sift_view_angle": dict(sift=True, view_angle=True),
            "sift_all_fail": dict(sift=True, fail=True),
            "sift_omni_given": dict(sift=True, camera="omni")}


@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("L,F", [(1, 1), (50, 1), (37, 70), (1024, 1024), (3001, 257),
                                 (64, 4000)])
def test_project_match_kernel_matches_plain(dev, L, F, case):
    """The whole of project-and-match in one launch against its plain
    version; (64, 4000) holds more features than a block's shared memory."""
    args, kw = project_match_scene(np.random.default_rng(L + F), L, F, dev, **K5_CASES[case])
    before = projmatch.project_match_core.launches
    feat, dist = projmatch.project_match_core(*args, **kw)
    assert projmatch.project_match_core.launches == before + 1
    rfeat, rdist = projmatch.project_match_plain(*args, **kw)
    assert torch.equal(feat, rfeat)
    assert torch.equal(dist, rdist)
    again = projmatch.project_match_core(*args, **kw)
    assert torch.equal(again[0], feat) and torch.equal(again[1], dist)
    if case.endswith("all_fail"):
        assert not bool((feat >= 0).any())
    elif L >= 37 and F >= 70:
        assert int((feat >= 0).sum()) > 0


def test_project_match_refuses_bad_inputs(dev):
    args, kw = project_match_scene(np.random.default_rng(0), 20, 30, dev)
    bad = list(args)
    bad[2] = args[2].float()  # p_w float32
    with pytest.raises(ValueError):
        projmatch.project_match_core(*bad, **kw)
    bad = list(args)
    bad[7] = args[7].cpu()  # kp_uv on the CPU
    with pytest.raises(RuntimeError):
        projmatch.project_match_core(*bad, **kw)


# stage 2 scenes (utils/synthetic.p3p_scene): correspondences, matches,
# hypotheses, minimal sets from, case
K6_CASES = {"drain": (1024, 195, 300, "noise", None), "idx": (1024, 195, 300, "idx", None),
            "ragged": (100, 37, 37, "noise", None), "minimal": (3, 3, 1, "noise", None),
            "few_noise": (1024, 195, 300, "noise", "few"),
            "few_idx": (1024, 195, 300, "idx", "few"),
            "all_invalid": (1024, 195, 300, "noise", "degenerate"),
            "unstaged": (6000, 700, 64, "noise", None),
            "no_rows": (500, 500, 64, "noise", None)}


def _nan_equal(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("case", list(K6_CASES))
def test_p3p_ransac_kernel_matches_plain(dev, case):
    """All of stage 2 (minimal sets, P3P, scoring, the first best pose) in
    one launch against its plain version: counts, best pose and inlier mask
    exactly, every root's pose bit for bit (NaN where both are), equal on
    relaunch; "unstaged" has more correspondences than a block's shared
    memory holds, "no_rows" passes the correspondences without stage 1's
    rows."""
    N, n_valid, H, sets, kind = K6_CASES[case]
    args, kw = p3p_scene(np.random.default_rng(N + H), N, n_valid, H, dev, sets=sets,
                         case=kind)
    if case == "no_rows":
        rows = kw.pop("rows")
        args = [args[0][rows.clamp(min=0).long()].contiguous(), args[1],
                args[2] & (rows >= 0)]
    before = pnp.absolute_pose_ransac.launches
    got = pnp.absolute_pose_ransac(*args, **kw)
    again = pnp.absolute_pose_ransac(*args, **kw)
    assert pnp.absolute_pose_ransac.launches == before + 2
    ref = pnp.absolute_pose_ransac_plain(*args, **kw)
    assert torch.equal(got["counts"], ref["counts"])
    assert int(got["best"]) == int(ref["best"]) and int(got["n_inliers"]) == int(ref["n_inliers"])
    assert torch.equal(got["inliers"], ref["inliers"])
    for k in got:
        assert _nan_equal(got[k], again[k]), k
    assert _nan_equal(got["poses"], ref["poses"]) and _nan_equal(got["T_c_w"], ref["T_c_w"])
    if kind == "degenerate":
        assert not bool((got["counts"] >= 0).any()) and int(got["best"]) == 0
    elif kind is None and n_valid > 30:
        assert int(got["n_inliers"]) > n_valid // 2


def test_p3p_ransac_refuses_bad_inputs(dev):
    args, kw = p3p_scene(np.random.default_rng(0), 64, 20, 8, dev)
    with pytest.raises(ValueError):
        pnp.absolute_pose_ransac(args[0].float(), *args[1:], **kw)
    with pytest.raises(ValueError):
        pnp.absolute_pose_ransac(*args, **{**kw, "rows": kw["rows"].long()})
    with pytest.raises(RuntimeError):
        pnp.absolute_pose_ransac(args[0].cpu(), *args[1:], **kw)


@pytest.mark.parametrize("N,E", [(1, 1), (9, 20), (256, 1300)])
def test_pgo_matvec_kernel_matches_plain(dev, N, E):
    rng = np.random.default_rng(N + E)
    ei = rng.integers(0, N, E)
    ej = (ei + rng.integers(0, max(N, 1), E)) % N
    f64 = dict(dtype=torch.float64, device=dev)
    v = torch.tensor(rng.normal(size=(N, 6)), **f64)
    free = torch.tensor((rng.random(N) > 0.1).astype(np.float64), **f64)
    Ji = torch.tensor(rng.normal(size=(E, 6, 6)), **f64)
    Jj = torch.tensor(rng.normal(size=(E, 6, 6)), **f64)
    graph = pgo.matvec_graph(torch.tensor(ei, device=dev),
                             torch.tensor(ej, device=dev), N)
    before = pgo.matvec.launches
    out = pgo.matvec(v, free, Ji, Jj, graph, 1e-6)
    again = pgo.matvec(v, free, Ji, Jj, graph, 1e-6)
    assert pgo.matvec.launches == before + 2
    assert torch.equal(out, again)
    ref = pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6)
    rel = (out - ref).abs().max() / ref.abs().max()
    assert float(rel) <= 1e-12


def _gba_problem(n_kf, n_lm, max_obs, dev, seed=0):
    """A synthetic GBA problem on the card, with a dead keyframe, dead
    landmarks, masked and invalid observations and one live loop edge."""
    import dataclasses

    from covins_tpu_torch.ops import gba
    from covins_tpu_torch.utils import synthetic

    p, _, _ = synthetic.build_gba_problem(n_kf=n_kf, n_lm=n_lm, seed=seed,
                                          max_obs=max_obs, device="cpu")
    rng = np.random.default_rng(seed)
    o = p.obs_kf.shape[0]
    uv = p.obs_uv.clone()
    uv[: o // 10] += torch.from_numpy(20.0 * rng.normal(size=(o // 10, 2)))
    lms = p.lms.clone()
    lms[int(p.obs_lm[0])] = p.poses[int(p.obs_kf[0]), 4:7]  # at the camera: invalid
    kf_mask = p.kf_mask.clone()
    kf_mask[n_kf // 2] = False
    lm_mask = p.lm_mask & torch.from_numpy(rng.random(p.lm_mask.shape[0]) > 0.05)
    obs_mask = p.obs_mask & torch.from_numpy(rng.random(o) > 0.05)
    obs_w = p.obs_w * torch.from_numpy(1.0 / (1.0 + rng.integers(0, 4, o)))
    p = dataclasses.replace(p, obs_uv=uv, lms=lms, kf_mask=kf_mask, lm_mask=lm_mask,
                            obs_mask=obs_mask, obs_w=obs_w,
                            loop_i=torch.tensor([1]), loop_j=torch.tensor([n_kf - 1]),
                            loop_T=p.poses[None, 0].clone(),
                            loop_sqrt_info=torch.eye(6, dtype=torch.float64)[None],
                            loop_mask=torch.tensor([True]))
    return p, gba.problem_to(p, dev)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300)) if b.numel() else 0.0


@pytest.mark.parametrize("F,S,masks", [(1, 1, "prefix"), (7, 50, "prefix"),
                                       (255, 256, "prefix"), (9, 45, "holes"),
                                       (5, 33, "padding"), (4, 70, "holes")])
def test_imu_preintegrate_kernel_matches_plain(dev, F, S, masks):
    """K10 (one warp per factor, its samples in chunks of 32) against its
    plain version: sample counts that are not a multiple of 32, validity
    masks that end early ("prefix"), have holes, or leave a factor with
    padding only."""
    from covins_tpu_torch.ops import imu

    rng = np.random.default_rng(F + S)
    acc = rng.normal(size=(F, S, 3)) + [0.0, 0.0, 9.81]
    gyro = 0.5 * rng.normal(size=(F, S, 3))
    dts = np.full((F, S), 0.005)
    if masks == "holes":
        mask = (rng.random((F, S)) > 0.3).astype(np.float64)
    else:
        mask = (np.arange(S)[None, :] < rng.integers(1, S + 1, F)[:, None]).astype(np.float64)
    if masks == "padding":
        mask[F // 2] = 0.0
    bg, ba = 0.01 * rng.normal(size=(F, 3)), 0.05 * rng.normal(size=(F, 3))
    args = [torch.tensor(x, device=dev) for x in (acc, gyro, dts, mask, bg, ba)]
    before = imu.preintegrate.launches
    got = imu.preintegrate(*args, imu.default_noise())
    assert imu.preintegrate.launches == before + 1
    again = imu.preintegrate(*args, imu.default_noise())
    ref = imu.preintegrate_plain(*args, imu.default_noise())
    for name in ("dq", "dv", "dp", "J_q_bg", "J_v_bg", "J_v_ba", "J_p_bg", "J_p_ba",
                 "cov", "dt"):
        g, r = getattr(got, name), getattr(ref, name)
        assert torch.equal(g, getattr(again, name)), name
        assert _rel(g, r) <= 1e-13, (name, _rel(g, r))
    if masks == "padding":
        assert float(got.dt[F // 2]) == 0.0 and not got.cov[F // 2].any()


@pytest.mark.parametrize("huber", [0.0, 2.447])
@pytest.mark.parametrize("n_kf,n_lm,max_obs", [(3, 16, None), (12, 150, 700)])
def test_gba_reproj_blocks_kernel_matches_plain(dev, huber, n_kf, n_lm, max_obs):
    from covins_tpu_torch.ops import gba

    pc, pd = _gba_problem(n_kf, n_lm, max_obs, dev)
    gc, gd = gba.obs_graph(pc), gba.obs_graph(pd)
    before = gba.reproj_blocks.launches
    got = gba.reproj_blocks(pd, gd, huber, "linearize")
    assert gba.reproj_blocks.launches == before + 1
    again = gba.reproj_blocks(pd, gd, huber, "linearize")
    ref = gba.reproj_blocks_plain(pd, gd, huber, "linearize")
    cpu = gba.reproj_blocks(pc, gc, huber, "linearize")
    for g, a, r, c in zip(got, again, ref, cpu):
        assert torch.equal(g, a)
        assert _rel(g, r) <= 1e-13 and _rel(g.cpu(), c) <= 1e-13
    val, valid = gba.reproj_blocks(pd, gd, huber, "outlier")
    rval, rvalid = gba.reproj_blocks_plain(pd, gd, huber, "outlier")
    assert torch.equal(valid, rvalid) and not bool(valid.all())
    assert _rel(val, rval) <= 1e-13
    # the cost of S stacked states in one launch, each state's sum against
    # its own plain evaluation, and bit for bit across two launches
    for S in (1, 7):
        st = stacked_states(pd, S)
        ps = gba._with_state(pd, st)
        before = gba.reproj_blocks.launches
        cost = gba.reproj_blocks(ps, gd, huber, "cost")
        assert gba.reproj_blocks.launches == before + 1 and cost.shape == (S,)
        assert torch.equal(cost, gba.reproj_blocks(ps, gd, huber, "cost"))
        for k in range(S):
            one = gba._with_state(pd, tuple(x[k:k + 1] for x in st))
            ref = gba.reproj_blocks_plain(one, gd, huber, "cost")
            assert _rel(cost[k:k + 1], ref) <= 1e-13, (S, k)
    # the outlier decision at the threshold is the plain version's
    val, valid = gba.reproj_blocks(pd, gd, 0.0, "outlier")
    cval, cvalid = gba.reproj_blocks(pc, gc, 0.0, "outlier")
    assert torch.equal((val < 0.92).cpu(), cval < 0.92)


@pytest.mark.parametrize("camera", ["omni", "equidistant"])
@pytest.mark.parametrize("huber", [0.0, 2.447])
def test_gba_reproj_blocks_given_projection_matches_plain(dev, camera, huber):
    """K8 for the cameras it does not project itself (the unified model,
    equidistant distortion), the projection handed to it from PyTorch: the
    linearisation, the cost of 1 and 7 stacked states and the outlier norm
    against the plain version to 1e-13 relative, validity exactly, bit for
    bit on relaunch."""
    import dataclasses

    from covins_tpu_torch.ops import gba
    from covins_tpu_torch.utils import synthetic

    pc, _, _ = synthetic.build_gba_problem(n_kf=12, n_lm=150, max_obs=700, device="cpu",
                                           camera=camera)
    rng = np.random.default_rng(1)
    o = pc.obs_kf.shape[0]
    uv = pc.obs_uv.clone()
    uv[: o // 10] += torch.from_numpy(20.0 * rng.normal(size=(o // 10, 2)))
    lms = pc.lms.clone()
    lms[int(pc.obs_lm[0])] = pc.poses[int(pc.obs_kf[0]), 4:7]  # at the camera: invalid
    pc = dataclasses.replace(pc, obs_uv=uv, lms=lms)
    pd = gba.problem_to(pc, dev)
    gd = gba.obs_graph(pd)
    before = gba.reproj_blocks.launches
    got = gba.reproj_blocks(pd, gd, huber, "linearize")
    again = gba.reproj_blocks(pd, gd, huber, "linearize")
    assert gba.reproj_blocks.launches == before + 2
    ref = gba.reproj_blocks_plain(pd, gd, huber, "linearize")
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        assert _rel(g, r) <= 1e-13
    val, valid = gba.reproj_blocks(pd, gd, huber, "outlier")
    rval, rvalid = gba.reproj_blocks_plain(pd, gd, huber, "outlier")
    assert torch.equal(valid, rvalid) and not bool(valid.all())
    assert _rel(val, rval) <= 1e-13
    for S in (1, 7):
        st = stacked_states(pd, S)
        ps = gba._with_state(pd, st)
        cost = gba.reproj_blocks(ps, gd, huber, "cost")
        assert torch.equal(cost, gba.reproj_blocks(ps, gd, huber, "cost"))
        for k in range(S):
            one = gba._with_state(pd, tuple(x[k:k + 1] for x in st))
            assert _rel(cost[k:k + 1], gba.reproj_blocks_plain(one, gd, huber, "cost")) <= 1e-13


@pytest.mark.parametrize("n_kf,n_lm,max_obs", [(3, 16, None), (12, 150, 700)])
def test_gba_reduced_matvec_kernel_matches_plain(dev, n_kf, n_lm, max_obs):
    from covins_tpu_torch.ops import gba, linalg

    _, pd = _gba_problem(n_kf, n_lm, max_obs, dev)
    g = gba.obs_graph(pd)
    _, Jp, Jl, _, _, _, Hll = gba.reproj_blocks_plain(pd, g, 0.0, "linearize")
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    Hinv = (linalg.inv33(Hll + 1e-4 * eye) * pd.lm_mask[:, None, None]).contiguous()
    rng = np.random.default_rng(n_kf)
    n, m = pd.poses.shape[0], pd.lms.shape[0]
    v6 = torch.tensor(rng.normal(size=(n, 6)), device=dev)
    c = torch.tensor(rng.normal(size=(m, 3)), device=dev)
    for vv, cc, t_only in ((v6, None, False), (None, c, False), (v6, c, False),
                           (v6, None, True)):
        before = gba.reduced_matvec.launches
        got = gba.reduced_matvec(vv, cc, Jp, Jl, Hinv, g, n, t_only)
        assert gba.reduced_matvec.launches == before + 1
        assert torch.equal(got, gba.reduced_matvec(vv, cc, Jp, Jl, Hinv, g, n, t_only))
        ref = gba.reduced_matvec_plain(vv, cc, Jp, Jl, Hinv, g, n, t_only)
        scale = gba.reduced_matvec_error_scale(vv, cc, Jp, Jl, Hinv, g, n, t_only)
        assert float(((got - ref).abs() / scale.clamp(min=1e-300)).max()) <= 1e-13


def test_gba_kernels_refuse_bad_inputs(dev):
    from covins_tpu_torch.ops import gba, imu

    _, pd = _gba_problem(3, 16, None, dev)
    g = gba.obs_graph(pd)
    _, Jp, Jl, _, _, _, Hll = gba.reproj_blocks_plain(pd, g, 0.0, "linearize")
    n = pd.poses.shape[0]
    with pytest.raises(ValueError):
        gba.reduced_matvec(torch.zeros((n, 5), dtype=torch.float64, device=dev), None,
                           Jp, Jl, Hll, g, n)
    with pytest.raises(RuntimeError):
        gba.reduced_matvec(torch.zeros((n, 6), dtype=torch.float64), None, Jp, Jl, Hll, g, n)
    z = torch.zeros((2, 4, 3), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        imu.preintegrate(z, z, z[..., 0], z[..., 0], z[:, 0], z[:, 0], imu.default_noise())


# ------------------------------------------------- the PCG kernels
# Each PCG kernel runs a Gauss-Newton step's whole loop in one launch; it
# is held to its plain loop (PyTorch alone: its matvec the plain version
# too) on the same inputs within PCG_FACTOR times the largest of the plain
# loop's own changes under three rounding differences: one ulp added to
# every entry of b, one ulp taken off, and its two dot products per
# iteration summed in reverse order instead of torch.sum's (the loops stop
# far from convergence and amplify any rounding difference alike; the
# kernel sums in its own order), and bit for bit across two launches.
PCG_FACTOR = 10.0


def _reversed_total(x):
    return torch.cumsum(x.reshape(-1).flip(0), 0)[-1]


def _pcg_check(kernel, plain, b):
    """(kernel result, its difference to the plain loop ``plain(b,
    total)``, the loop's readings); the kernel launched twice with equal
    bits.  The readings are printed (``pytest -s`` shows them)."""
    x, again = kernel(b), kernel(b)
    assert torch.equal(x, again)
    x0 = plain(b, torch.sum)
    moved = {"one_ulp_up": plain(torch.nextafter(b, torch.full_like(b, float("inf"))),
                                 torch.sum),
             "one_ulp_down": plain(torch.nextafter(b, torch.full_like(b, -float("inf"))),
                                   torch.sum),
             "reordered_sums": plain(b, _reversed_total)}
    readings = {k: float((y - x0).abs().max()) if y.numel() else 0.0
                for k, y in moved.items()}
    diff = float((x - x0).abs().max()) if x.numel() else 0.0
    print({"max_abs_err": diff, **readings})
    assert diff <= PCG_FACTOR * max(readings.values()), (diff, readings)
    return x, diff, readings


def _pose_graph_system(n_kf, dev, n_loops=5, weight=None):
    import dataclasses

    from covins_tpu_torch.utils import synthetic

    g, _ = synthetic.build_pose_graph(n_kf=n_kf, n_loops=n_loops, seed=n_kf, device=dev)
    if weight is not None:  # every edge's rotation and translation weight
        g = dataclasses.replace(g, edge_sqrt_info=pgo.make_sqrt_info(
            weight, weight, g.edge_i.shape[0], device=dev).contiguous())
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, n_kf)
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)
    return b, Minv, free, Ji, Jj, graph


@pytest.mark.parametrize("n_kf,n_iters,weight", [
    (2, 1, None), (37, 0, None), (37, 1, None), (37, 100, None), (256, 100, None),
    # all weights 100: the CG stagnates and one ulp of b alone moves the loop
    # 25-fold more or less from one b to the next
    (256, 100, 100.0)])
def test_pgo_pcg_kernel_matches_plain_loop(dev, n_kf, n_iters, weight):
    b, Minv, free, Ji, Jj, graph = _pose_graph_system(n_kf, dev, weight=weight)
    before = (pgo.pcg.launches, pgo.matvec.launches)

    def kernel(bb):
        return pgo.pcg(bb, Minv, free, Ji, Jj, graph, 1e-6, n_iters)

    def plain(bb, total):
        return pgo._pcg(lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6), bb, Minv,
                        free, n_iters, total)

    x, _, _ = _pcg_check(kernel, plain, b)
    assert (pgo.pcg.launches, pgo.matvec.launches) == (before[0] + 2, before[1])
    if n_iters == 0:
        assert not bool(x.any())


def test_pgo_pcg_refuses_bad_inputs(dev):
    b, Minv, free, Ji, Jj, graph = _pose_graph_system(9, dev)
    with pytest.raises(ValueError):
        pgo.pcg(b[:, :5].contiguous(), Minv, free, Ji, Jj, graph, 1e-6, 3)
    with pytest.raises(ValueError):
        pgo.pcg(b, Minv.float(), free, Ji, Jj, graph, 1e-6, 3)
    with pytest.raises(ValueError):
        pgo.pcg(b, Minv, free, Ji, Jj, graph, 1e-6, -1)
    with pytest.raises(RuntimeError):
        pgo.pcg(b.cpu(), Minv, free, Ji, Jj, graph, 1e-6, 3)


def _thin(p, counts):
    """``p`` with the first landmarks seen three times or more keeping only
    their first counts[k] observations."""
    import dataclasses

    keep = torch.ones(p.obs_kf.shape[0], dtype=torch.bool)
    seen = torch.bincount(p.obs_lm, minlength=p.lms.shape[0])
    for lm, c in zip(torch.nonzero(seen >= 3)[:, 0].tolist(), counts):
        idx = torch.nonzero(p.obs_lm == lm)[:, 0]
        keep[idx[c:]] = False
    return dataclasses.replace(p, obs_kf=p.obs_kf[keep], obs_lm=p.obs_lm[keep],
                               obs_uv=p.obs_uv[keep], obs_w=p.obs_w[keep],
                               obs_mask=p.obs_mask[keep])


def _gba_system(dev, n_kf=12, n_lm=150, max_obs=700, thin=False, loops=True,
                visual_only=False, huber=0.0):
    import dataclasses

    from covins_tpu_torch.ops import gba

    pc, _ = _gba_problem(n_kf, n_lm, max_obs, dev)
    if thin:  # landmarks seen 0, 1 and 2 times
        pc = _thin(pc, [0, 1, 2, 0, 1, 2])
    pd = gba.problem_to(pc, dev)
    g = gba.obs_graph(pd)
    s = gba.reduced_system(pd, g, (pd.poses, pd.vels, pd.biases, pd.lms),
                           torch.tensor(1e-4, dtype=torch.float64, device=dev),
                           visual_only, huber)
    if not loops:  # no loop factor at all (L = 0)
        f = s.fac
        s = dataclasses.replace(s, fac=gba.factors(
            f.loop_i[:0], f.loop_j[:0], f.Ji_l[:0], f.Jj_l[:0], f.imu_i, f.imu_j, f.Ji_f,
            f.Jj_f, pd.poses.shape[0]))
    return s, g, pd


GBA_PCG_CASES = {
    "bench_like": dict(), "huber": dict(huber=2.447), "visual_only": dict(visual_only=True),
    "no_loops": dict(loops=False), "thin_landmarks": dict(thin=True),
    "five_keyframes": dict(n_kf=5, n_lm=40, max_obs=None),
}


@pytest.mark.parametrize("n_cg", [0, 1, 60])
@pytest.mark.parametrize("case", list(GBA_PCG_CASES))
def test_gba_pcg_kernel_matches_plain_loop(dev, case, n_cg):
    import dataclasses

    from covins_tpu_torch.ops import gba

    s, g, _ = _gba_system(dev, **GBA_PCG_CASES[case])
    before = (gba.pcg.launches, gba.reduced_matvec.launches)

    def kernel(b):
        return gba.pcg(dataclasses.replace(s, b_red=b), g, n_cg)

    def plain(b, total):
        return gba.pcg_plain(dataclasses.replace(s, b_red=b), g, n_cg,
                             gba.reduced_matvec_plain, total)

    x, _, _ = _pcg_check(kernel, plain, s.b_red)
    assert (gba.pcg.launches, gba.reduced_matvec.launches) == (before[0] + 2, before[1])
    if n_cg == 0:
        assert not bool(x.any())


def test_gba_step_launches(dev):
    """One Gauss-Newton step launches the PCG kernel once, K9 seven times
    (b_red and the six ladder scales), never inside the PCG, and K8 twice
    (the linearisation, and the costs of the six ladder states and the
    current one)."""
    from covins_tpu_torch.ops import gba

    _, g, pd = _gba_system(dev)
    before = (gba.pcg.launches, gba.reduced_matvec.launches, gba.reproj_blocks.launches)
    gba._gn_schur_step(pd, g, (pd.poses, pd.vels, pd.biases, pd.lms),
                       torch.tensor(1e-4, dtype=torch.float64, device=dev), 60, False)
    after = (gba.pcg.launches, gba.reduced_matvec.launches, gba.reproj_blocks.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 7, 2)


@pytest.mark.parametrize("case", ["thin_landmarks", "five_keyframes"])
def test_gba_reduced_matvec_ragged_matches_plain(dev, case):
    from covins_tpu_torch.ops import gba

    s, g, pd = _gba_system(dev, **GBA_PCG_CASES[case])
    n, m = pd.poses.shape[0], pd.lms.shape[0]
    rng = np.random.default_rng(m)
    v6 = torch.tensor(rng.normal(size=(n, 6)), device=dev)
    c = torch.tensor(rng.normal(size=(m, 3)), device=dev)
    for vv, cc, t_only in ((v6, None, False), (None, c, False), (v6, c, False),
                           (v6, None, True)):
        got = gba.reduced_matvec(vv, cc, s.Jp, s.Jl, s.Hll_inv, g, n, t_only)
        assert torch.equal(got, gba.reduced_matvec(vv, cc, s.Jp, s.Jl, s.Hll_inv, g, n,
                                                   t_only))
        ref = gba.reduced_matvec_plain(vv, cc, s.Jp, s.Jl, s.Hll_inv, g, n, t_only)
        scale = gba.reduced_matvec_error_scale(vv, cc, s.Jp, s.Jl, s.Hll_inv, g, n, t_only)
        assert float(((got - ref).abs() / scale.clamp(min=1e-300)).max()) <= 1e-13


def test_gba_pcg_refuses_bad_inputs(dev):
    import dataclasses

    from covins_tpu_torch.ops import gba

    s, g, _ = _gba_system(dev, n_kf=3, n_lm=16, max_obs=None)
    with pytest.raises(ValueError):
        gba.pcg(dataclasses.replace(s, b_red=s.b_red[:, :14].contiguous()), g, 3)
    with pytest.raises(ValueError):
        gba.pcg(dataclasses.replace(s, M_inv=s.M_inv.float()), g, 3)
    with pytest.raises(ValueError):
        gba.pcg(s, g, -1)
    with pytest.raises(RuntimeError):
        gba.pcg(dataclasses.replace(s, b_red=s.b_red.cpu()), g, 3)


def test_pcg_kernels_raise_when_the_launch_is_refused(dev, monkeypatch):
    """A cooperative launch the C side refuses (here: a grid larger than
    the block slots the wrapper provides) raises; no eager loop runs
    instead and no launch is counted."""
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import gba

    s, g, _ = _gba_system(dev, n_kf=5, n_lm=40, max_obs=None)
    b, Minv, free, Ji, Jj, graph = _pose_graph_system(9, dev)
    monkeypatch.setattr(cuda_build, "SLOT_CAP", 0)
    before = (gba.pcg.launches, pgo.pcg.launches, gba.reduced_matvec.launches,
              pgo.matvec.launches)
    with pytest.raises(RuntimeError):
        gba.pcg(s, g, 3)
    with pytest.raises(RuntimeError):
        pgo.pcg(b, Minv, free, Ji, Jj, graph, 1e-6, 3)
    assert (gba.pcg.launches, pgo.pcg.launches, gba.reduced_matvec.launches,
            pgo.matvec.launches) == before


# ------------------------------------------------------------------ K11
@pytest.mark.parametrize("M,seg,n_seg,case", [
    (1, 2, 1, None), (37, 13, 3, None), (2048, 1024, 3, None), (100, 1500, 2, "ties"),
    (64, 1030, 3, "ties"), (50, 40, 3, "all_masked"), (33, 300, 2, "extremes"),
    (6, 512, 40, None)])
def test_hamming_ratio_match_matches_plain(dev, M, seg, n_seg, case):
    rng = np.random.default_rng(M + seg)
    t = [torch.from_numpy(x).to(dev) for x in ratio_match_scene(rng, M, seg, n_seg, case)]
    n0 = descriptors.hamming_ratio_match.launches
    got = descriptors.hamming_ratio_match(*t, seg, 40.0, 0.8)
    again = descriptors.hamming_ratio_match(*t, seg, 40.0, 0.8)
    plain = descriptors.hamming_ratio_match_plain(*t, seg, 40.0, 0.8)
    torch.cuda.synchronize()
    assert descriptors.hamming_ratio_match.launches == n0 + 2
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, p) and torch.equal(g, a)
    if case == "extremes":
        assert got[1][0, 0] == 0 and got[1][2, 0] == 0 and got[2][2, 0] <= 256
    if case == "all_masked":
        assert (got[0] == -1).all() and (got[1] == 2**30).all()


def test_hamming_ratio_match_refuses_bad_inputs(dev):
    a = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
    m = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="segments"):
        descriptors.hamming_ratio_match(a, m, a[:3], m[:3], 2, 40.0, 0.8)
    with pytest.raises(ValueError, match="two columns"):
        descriptors.hamming_ratio_match(a, m, a, m, 1, 40.0, 0.8)
    with pytest.raises(ValueError):
        descriptors.hamming_ratio_match(a[:, :16].contiguous(), m, a, m, 2, 40.0, 0.8)
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.hamming_ratio_match(a, m, a.cpu(), m.cpu(), 2, 40.0, 0.8)


# K11's top-2 entry (the row-sharded Hamming k-NN): (M, N), ragged, one
# row, two columns, the verification's 2048 x 3072, columns past one
# shared-memory tile and over several parts; tied and duplicated rows
@pytest.mark.parametrize("M,N", [(1, 2), (37, 13), (300, 1030), (2048, 3072), (5, 9000)])
def test_hamming_knn2_matches_plain(dev, M, N):
    from covins_tpu_torch.utils.synthetic import knn_scene

    rng = np.random.default_rng(M + N)
    db, q = (descriptors.pack_pm1(torch.from_numpy(x)).to(dev) for x in knn_scene(rng, M, N))
    n0 = descriptors.hamming_knn2.launches
    got, again = descriptors.hamming_knn2(q, db), descriptors.hamming_knn2(q, db)
    plain = descriptors.hamming_knn2_plain(q, db)
    torch.cuda.synchronize()
    assert descriptors.hamming_knn2.launches == n0 + 2
    for g, a, p in zip(got, again, plain):
        assert g.shape == (M, 2) and torch.equal(g, p) and torch.equal(g, a)
    # k 5 takes K1's distances and a stable sort
    k = min(5, N)
    n1 = descriptors.hamming_argmin.launches
    d5, i5 = descriptors.hamming_knn(q, db, k)
    want = descriptors.hamming_knn_plain(q.cpu(), db.cpu(), k)
    assert descriptors.hamming_argmin.launches == n1 + (1 if k > 2 else 0)
    assert torch.equal(d5.cpu(), want[0]) and torch.equal(i5.cpu(), want[1])


def test_hamming_knn2_refuses_bad_inputs(dev):
    a = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="2 <= N"):
        descriptors.hamming_knn2(a, a[:1])
    with pytest.raises(ValueError):
        descriptors.hamming_knn2(a[:, :16].contiguous(), a)
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.hamming_knn2(a, a.cpu())


def test_sharded_paths_on_the_card_world1(dev):
    """The multi-device dry run on the card: a group of one over NCCL
    (`parallel.sharding.make_mesh`), its four legs and their asserts."""
    import torch.distributed as dist

    from covins_tpu_torch.parallel import sharding as sh
    from covins_tpu_torch.parallel.dryrun import dryrun_multichip

    try:
        mesh = sh.make_mesh()
        assert mesh.backend == "nccl" and mesh.device == dev and mesh.world == 1
        n0 = descriptors.hamming_knn2.launches
        out = dryrun_multichip(mesh)
        assert out["knn"] == (5, 0) and descriptors.hamming_knn2.launches == n0 + 1
        with pytest.raises(ValueError, match="256-bit"):
            sh.sharded_hamming_knn(mesh, torch.ones((8, 128), device=dev),
                                   torch.ones((1, 128), device=dev))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ K12
K12_CASES = {
    "central": dict(B=6, H=2000, N=1024, central=True, with_valid=True),
    "noncentral": dict(B=1, H=512, N=6144),
    "refine": dict(B=1, H=1, N=6144, nan_every=0),
    "covariance": dict(B=1, H=60, N=6144, counts_only=True),
    "ragged": dict(B=3, H=7, N=37, with_valid=True),
    "one": dict(B=1, H=1, N=1, nan_every=0),
}


@pytest.mark.parametrize("case", list(K12_CASES))
def test_ray_ransac_score_matches_plain(dev, case):
    kw = dict(K12_CASES[case])
    counts_only = kw.pop("counts_only", False)
    rng = np.random.default_rng(len(case))
    ins = [None if x is None else torch.from_numpy(x).to(dev)
           for x in ray_score_scene(rng, **kw)]
    T, va, fa, vb, fb, mask, valid = ins
    n0 = epipolar.ray_ransac_score.launches
    args = (T, va, fa, vb, fb, mask, 0.004)
    got = epipolar.ray_ransac_score(*args, valid=valid, want_inliers=not counts_only)
    again = epipolar.ray_ransac_score(*args, valid=valid, want_inliers=not counts_only)
    plain = epipolar.ray_ransac_score_plain(*args, valid=valid,
                                            want_inliers=not counts_only)
    torch.cuda.synchronize()
    assert epipolar.ray_ransac_score.launches == n0 + 2
    for g, a, p in zip(got, again, plain):
        if p is None:
            assert g is None and a is None
        else:
            assert torch.equal(g, p) and torch.equal(g, a)
    if kw.get("nan_every", 7):
        assert (got[0][:, ::7] == 0).all()  # NaN poses count nothing
    assert int(got[0].max()) > 0


def test_ray_ransac_score_refuses_bad_inputs(dev):
    T = torch.zeros((1, 2, 7), dtype=torch.float64, device=dev)
    f = torch.zeros((1, 5, 3), dtype=torch.float64, device=dev)
    m = torch.ones((1, 5), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="mask"):
        epipolar.ray_ransac_score(T, None, f, None, f, m[:, :4], 0.01)
    with pytest.raises(ValueError, match="fa"):
        epipolar.ray_ransac_score(T, None, f.float(), None, f, m, 0.01)
    with pytest.raises(RuntimeError, match="CUDA"):
        epipolar.ray_ransac_score(T, None, f.cpu(), None, f, m, 0.01)


# the central 5-point RANSAC whole: (B, H, N, sets, case)
K12_5PT_CASES = {"drain": (6, 50, 1024, "noise", None), "drain_idx": (6, 50, 1024, "idx", None),
                 "ragged": (3, 7, 37, "noise", None),
                 "degenerate": (3, 50, 1024, "noise", "degenerate"),
                 "degenerate_idx": (3, 50, 1024, "idx", "degenerate")}


@pytest.mark.parametrize("case", list(K12_5PT_CASES))
def test_relpose_ransac_5pt_matches_plain(dev, case):
    """The whole central 5-point RANSAC in one launch against its plain
    version: every pose bit for bit (NaN where both are), its validity,
    the counts, the best, its pose, count and inliers exactly, and the same
    across two launches; "degenerate" has a pair with 3 rays masked in
    (its sets take masked rays, as the stable sort does), one with none
    (it counts nothing) and one whose rays repeat 4 distinct rays (or
    whose given sets repeat a ray)."""
    B, H, N, sets, kind = K12_5PT_CASES[case]
    rng = np.random.default_rng(B * H + N)
    fa, fb, mask, noise, idx = (None if x is None else torch.from_numpy(x).to(dev)
                                for x in central_5pt_scene(rng, B, H, N, sets, kind))
    n0, s0 = epipolar.relpose_ransac_5pt.launches, epipolar.ray_ransac_score.launches
    got = epipolar.relpose_ransac_5pt(fa, fb, mask, H, 0.004, noise=noise, idx=idx)
    again = epipolar.relpose_ransac_5pt(fa, fb, mask, H, 0.004, noise=noise, idx=idx)
    plain = epipolar.relative_pose_ransac_central_5pt_plain(fa, fb, mask, H, 0.004,
                                                            noise=noise, idx=idx)
    torch.cuda.synchronize()
    assert epipolar.relpose_ransac_5pt.launches == n0 + 2
    assert epipolar.ray_ransac_score.launches == s0
    assert set(got) == set(plain)
    for k in plain:
        assert _nan_equal(got[k], again[k]), k
        assert _nan_equal(got[k], plain[k]), (k, int((~((got[k] == plain[k])
                                                        | (got[k].isnan()
                                                           & plain[k].isnan()))).sum()))
    assert int(got["valid"].sum()) > 0
    if kind == "degenerate":
        assert int(got["n_inliers"][1]) == 0 and not bool(got["inliers"][1].any())
    else:
        assert bool((got["n_inliers"] > 0).all())


@pytest.mark.parametrize("solver", ["5pt", "8pt"])
def test_covinsg_verify_on_the_card_matches_the_cpu(dev, solver):
    """The whole COVINS-G verification at the path's width (rigs of 2 and
    3 keyframes of 1024 features) on the card (K11 once, K12 four times:
    with the 5-point solver its central RANSACs whole, then three scorings)
    against the same on the CPU (plain versions), with the same draws and,
    after a first call, no host synchronisation on the card's way (sync
    debug mode): the gates, every pair's matches and central inliers, the
    pool and the 17-point inliers exactly; T_12 and the covariance no
    further from the CPU's (relative to the largest entry) than the CPU's
    own result moves when one rig's ray directions move by one ulp (up or
    down).  The solvers are device-exact up to `svd3x3`, whose
    transcendental functions round apart on the card, and a near-singular
    17-ray re-solve amplifies that in its projection to SO(3):
    `scripts/port_covg_cov_probe.py` read the covariances 1.7e-5 / 9.5e-8
    apart (5- / 8-point) against spreads of 9.9e-5 / 2.8e-6 (NVIDIA H100
    80GB HBM3, 700 W)."""
    from covins_tpu_torch.ops import loopverify
    from covins_tpu_torch.utils.synthetic import covins_g_scene

    rng = np.random.default_rng(5)
    F, nq, nc = 1024, 2, 3
    sc = covins_g_scene(rng, F, nq, nc, n_points=400, n_inliers=300, n_outliers=200)
    n_hyp5 = 50 if solver == "5pt" else 200
    g = lambda *shape: -np.log(-np.log(np.clip(rng.random(shape), 1e-300, None)))  # noqa: E731
    noise = {"noise5": g(nq * nc, n_hyp5, F), "noise17": g(512, nq * nc * F),
             "noise_cov": g(60, nq * nc * F)}
    keys = ("qo", "qd", "co", "cd", "q_desc", "c_desc", "qmask", "cmask", "qbear", "cbear")
    params = dict(img_match_thres=40.0, ratio_thres=0.8, thr5=float(np.arctan2(16.0, 458.0)),
                  rel_min_img_matches=20, rel_min_inliers=20,
                  thr17=float(np.arctan2(1.5, 458.0)), nc_min_inliers=100,
                  thr_cov_rad=float(np.arctan2(10.0, 458.0)), nc_cov_thres=10.0,
                  nq_rig=nq, nc_rig=nc, Fq=F, Fc=F, n_hyp5=n_hyp5, n_hyp17=512, n_cov=60,
                  solver=solver)
    arrays = {**{k: sc[k] for k in keys}, **noise}

    def run_cpu(arrays):
        t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
        return loopverify.covinsg_verify(*(t[k] for k in keys), **params,
                                         **{k: t[k] for k in noise})

    outs = []
    for d in (dev, torch.device("cpu")):
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(d) for k, v in arrays.items()}
        if d.type == "cuda":  # after a first call (which makes the solvers'
            # constants on the card), nothing waits for the card
            loopverify.covinsg_verify(*(t[k] for k in keys), **params,
                                      **{k: t[k] for k in noise})
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        n11, n12 = descriptors.hamming_ratio_match.launches, epipolar.ray_ransac_score.launches
        n5 = epipolar.relpose_ransac_5pt.launches
        try:
            out = loopverify.covinsg_verify(*(t[k] for k in keys), **params,
                                            **{k: t[k] for k in noise})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append({k: v.cpu() for k, v in out.items()})
        if d.type == "cuda":
            assert descriptors.hamming_ratio_match.launches == n11 + 1
            # the six central RANSACs: one launch of the whole 5-point
            # RANSAC, or the 8-point solve scored by one scoring launch
            five = int(solver == "5pt")
            assert epipolar.relpose_ransac_5pt.launches == n5 + five
            assert epipolar.ray_ransac_score.launches == n12 + 4 - five
    card, cpu = outs
    for k in ("ok", "pairs_ok", "n_inliers", "n_pool", "pair_n_match", "pair_n_inl"):
        assert torch.equal(card[k].to(torch.int64), cpu[k].to(torch.int64)), k
    assert bool(card["ok"])

    def rel(a, k):
        return float((a[k] - cpu[k]).abs().max() / cpu[k].abs().max())

    spread = {"T_12": 0.0, "cov": 0.0}
    for side in ("qd", "cd"):
        for direction in (np.inf, -np.inf):
            moved = run_cpu({**arrays, side: np.nextafter(arrays[side], direction)})
            for k in spread:
                spread[k] = max(spread[k], rel(moved, k))
    for k in spread:
        assert rel(card, k) <= spread[k], (k, rel(card, k), spread)


# ------------------------------------------------------------------ K13, K14
@pytest.mark.parametrize("M,N,case", [
    (1, 1, None), (37, 13, None), (130, 512, "ties"), (700, 1000, None),
    (12 * 1024, 512, None), (3000, 1024, "ties"), (65, 1024, "all_masked"),
    (50, 700, "extremes"), (6, 1024, "no_mask"), (3000, 1024, "overflow"),
    (70, 300, "overflow"), (500, 1024, "ulp")])
def test_l2_argmin_matches_plain(dev, M, N, case):
    """K13 against its plain version: word ids and minima bit for bit, the
    same across two launches, one launch a call; ties to the lower word;
    more near-equidistant words than a row's candidates (rescanned, and
    counted); distances one ulp apart."""
    rng = np.random.default_rng(M + N)
    a, am, b, _ = l2_match_scene(rng, M, N, 1, None if case == "no_mask" else case)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    tm = None if case == "no_mask" else torch.from_numpy(am).to(dev)
    counts = descriptors.l2_filter_counts(dev)
    counts.zero_()
    n0 = descriptors.l2_argmin.launches
    idx, dmin = descriptors.l2_argmin(ta, tb, tm)
    lists, cands, most, over = counts.tolist()
    idx2, dmin2 = descriptors.l2_argmin(ta, tb, tm)
    ridx, rdmin = descriptors.l2_argmin_plain(ta, tb, tm)
    torch.cuda.synchronize()
    assert descriptors.l2_argmin.launches == n0 + 2
    assert idx.dtype == torch.int32 and dmin.dtype == torch.float32
    assert torch.equal(idx, ridx) and torch.equal(dmin, rdmin)
    assert torch.equal(idx, idx2) and torch.equal(dmin, dmin2)
    if case == "ties":
        assert (idx[:8] == 3).all() and (dmin[:8] > 0).all()
    if case == "all_masked":
        assert (idx == -1).all()
    assert lists >= M and most <= descriptors.L2_FILTER_CANDIDATES
    if case == "overflow":
        assert over >= 8  # the 8 query rows equidistant to 12 words
    elif case in (None, "no_mask", "ulp"):
        assert over == 0 and cands >= lists
    if case == "ulp":
        assert (idx[:8] == 600).all()  # the nearest, at the highest column


def test_l2_argmin_refuses_bad_inputs(dev):
    a = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    shifted = torch.zeros(8 * 128 + 1, dtype=torch.float32, device=dev)[1:]
    with pytest.raises(ValueError):
        descriptors.l2_argmin(a[:, :64].contiguous(), a)  # not 128 dimensions
    with pytest.raises(ValueError):
        descriptors.l2_argmin(a.double(), a)
    with pytest.raises(ValueError):
        descriptors.l2_argmin(shifted.view(8, 128), a)  # not 16-byte aligned
    with pytest.raises(ValueError):
        descriptors.l2_argmin(a, a, torch.ones(8, device=dev))
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.l2_argmin(a, a.cpu())


@pytest.mark.parametrize("M,seg,n_seg,case,ratio", [
    (1, 2, 1, None, 0.8), (37, 13, 3, None, 0.8), (2048, 1024, 3, None, 0.8),
    (100, 1500, 2, "ties", 0.8), (100, 1500, 2, "ties", 1.5), (64, 1030, 3, "ties", 1.5),
    (50, 40, 3, "all_masked", 0.8), (33, 300, 2, "one_valid", 0.8),
    (20, 100, 2, "extremes", 0.8), (6, 512, 40, None, 0.8),
    (100, 1500, 2, "overflow", 1.5), (100, 1500, 2, "overflow", 0.8),
    (64, 1030, 3, "ulp", 1.5), (150, 100, 4, "mask_patterns", 0.8),
    (300, 600, 4, "mask_patterns", 0.8), (2048, 1024, 3, "mask_patterns", 0.8)])
def test_l2_ratio_match_matches_plain(dev, M, seg, n_seg, case, ratio):
    """K14 against its plain version: indices, d1 and d2 bit for bit, the
    same across two launches, one launch a call.  A tie at the best
    distance (d1 = d2) fails a ratio gate below 1, so the tie cases also
    run with ratio 1.5, where the lower column's index shows.  Also more
    near-equidistant columns than a row's candidates, distances one ulp
    apart, and masks: a whole row tile masked, valid rows not a multiple of
    64, segments of 0, 1 and 2 valid columns."""
    rng = np.random.default_rng(M + seg)
    t = [torch.from_numpy(x).to(dev) for x in l2_match_scene(rng, M, seg, n_seg, case)]
    max_dist = 500.0
    counts = descriptors.l2_filter_counts(dev)
    counts.zero_()
    n0 = descriptors.l2_ratio_match.launches
    got = descriptors.l2_ratio_match(*t, seg, max_dist, ratio)
    lists, cands, most, over = counts.tolist()
    again = descriptors.l2_ratio_match(*t, seg, max_dist, ratio)
    plain = descriptors.l2_ratio_match_plain(*t, seg, max_dist, ratio)
    torch.cuda.synchronize()
    assert descriptors.l2_ratio_match.launches == n0 + 2
    assert got[0].dtype == torch.int32 and got[1].dtype == got[2].dtype == torch.float32
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, p) and torch.equal(g, a)
    if case == "ties":
        assert (got[1][:8, 0] == got[2][:8, 0]).all() and (got[1][:8, 0] > 0).all()
        assert (got[0][:8, 0] == (3 if ratio > 1 else -1)).all()
    if case == "all_masked":
        assert (got[0] == -1).all() and (got[1] == 2**30).all()
    if case == "one_valid":
        assert (got[2][:, 0] == 2**30).all()
    if M > 10 and case != "all_masked":
        assert int((got[0] >= 0).sum()) > 0
    assert most <= descriptors.L2_FILTER_CANDIDATES
    if case == "overflow":
        assert over > 0
    elif case in (None, "ulp", "mask_patterns"):
        assert over == 0
    if case == "mask_patterns":
        assert (got[0][:64] == -1).all() and (got[1][:64] == 2**30).all()
        assert (got[1][:, 0] == 2**30).all() and (got[2][:, 1] == 2**30).all()
        assert (got[1][:, 2] < 2**30).any() and (got[2][:, 2] < 2**30).any()


@pytest.mark.parametrize("M,N,case", [(2048, 3072, None), (500, 1024, "ulp"),
                                      (3000, 1024, "overflow"), (50, 700, "extremes")])
def test_l2_filter_stays_within_its_bound(dev, M, N, case):
    """The tensor-core filter's distance (the kernels' own tile products,
    `l2_filter_values`) within `l2_filter_threshold` of the plain distance
    for every pair, and the product's share of the error, |d~ - d| less
    the two subtractions' rounding 4u (aa + bb), within C_TC / 8 of 2
    sqrt(aa bb).  (Where aa >> bb, as for the extremes scene's 1e4 row
    against norm-512 words, the rounding of aa + bb alone is most of
    |d~ - d|.)"""
    rng = np.random.default_rng(M + N)
    a, _, b, _ = (torch.from_numpy(x).to(dev) for x in l2_match_scene(rng, M, N, 1, case))
    dt = descriptors.l2_filter_values(a, b).double()
    dp = descriptors.l2_distance_sq(a, b).double()
    aa, bb = descriptors.sum_squares(a).double(), descriptors.sum_squares(b).double()
    err = (dt - dp).abs()
    assert bool((err <= descriptors.l2_filter_threshold(aa, bb)).all())
    scale = torch.sqrt(aa[:, None] * bb[None, :])
    raw = float((err / scale.clamp(min=1e-30))[scale > 0].max())
    share = ((err - 2.0**-22 * (aa[:, None] + bb[None, :])).clamp(min=0.0)
             / (2 * scale.clamp(min=1e-30)))[scale > 0].max()
    c = descriptors.L2_FILTER_REL_ERR
    print(f"{case}: filter error {raw / c:.4g} C_TC, the product's {float(share) / c:.4g}")
    assert float(share) <= c / 8


def test_l2_ratio_match_refuses_bad_inputs(dev):
    a = torch.zeros((4, 128), dtype=torch.float32, device=dev)
    m = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="segments"):
        descriptors.l2_ratio_match(a, m, a[:3], m[:3], 2, 500.0, 0.8)
    with pytest.raises(ValueError, match="two columns"):
        descriptors.l2_ratio_match(a, m, a, m, 1, 500.0, 0.8)
    with pytest.raises(ValueError):
        descriptors.l2_ratio_match(a[:, :64].contiguous(), m, a, m, 2, 500.0, 0.8)
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.l2_ratio_match(a, m, a.cpu(), m.cpu(), 2, 500.0, 0.8)


def test_insert_and_score_l2_matches_the_cpu(dev):
    """A SIFT window's insert-and-score on the card (K13, then K3, reading
    one packed upload) against the CPU's plain versions: the database rows
    and the (W, 2, n) result bit for bit."""
    from covins_tpu_torch.models.kf_database import KeyframeDatabase
    from covins_tpu_torch.utils.synthetic import sift_descriptors

    rng = np.random.default_rng(9)
    vocab = sift_descriptors(rng, 512)
    kfs = [np.abs(vocab[rng.integers(0, 512, n)] + rng.normal(0.0, 30.0, (n, 128))
                  ).astype(np.float32) for n in (1024, 700, 1, 1024)]
    ids = [(i, 0) for i in range(len(kfs))]
    out = []
    for d in (dev, "cpu"):
        db = KeyframeDatabase(vocab, capacity=4, device=d)
        n13, n3 = descriptors.l2_argmin.launches, bow.bow_insert_score.launches
        res = db.add_and_query_batch(ids, kfs)
        res += db.add_and_query_batch([(9, 1)], kfs[:1])
        if d is dev:
            assert descriptors.l2_argmin.launches == n13 + 2
            assert bow.bow_insert_score.launches == n3 + 2
        out.append((db.db.cpu(), res))
    (g_db, g_res), (c_db, c_res) = out
    assert torch.equal(g_db, c_db)
    for g, c in zip(g_res, c_res):
        assert np.array_equal(g["scores"], c["scores"]) and np.array_equal(g["common"],
                                                                            c["common"])


# K15: (n_kf, n_lm, O, case) — ragged; no live observation; a keyframe
# with none; landmarks seen far more than six times; one observation; the
# five-agent map's order of size; observations sorted by keyframe (the
# others are unsorted); far more keyframes than observations; one
# keyframe's segment longer than a block sorts at once (taken in windows);
# masks other than 0 and 1 (truncated counts, ordered mask sums);
# prunemap's size in a map's order (sorted by keyframe, 5% appended later);
# more keyframes than a block scans itself, each with more observations
# than a thread sums; segments wider than one group of windows
K15_CASES = [(37, 3001, 12345, "ragged"), (9, 40, 700, "no_live_obs"),
             (12, 200, 800, "kf_without_obs"), (6, 3, 500, "many_obs_per_lm"),
             (4, 7, 1, "one_obs"), (160, 40_000, 200_000, "large"),
             (25, 1200, 5000, "sorted"), (1_000_000, 10_000, 50_000, "many_kfs"),
             (5, 9, 0, "no_obs"), (1, 5000, 200_000, "one_kf"),
             (37, 3001, 12345, "fractional_mask"), (160, 27_441, 101_712, "prunemap_like"),
             (6000, 40_000, 150_000, "many_kfs_listed"),
             (400, 1_000_000, 4_300_000, "two_groups")]


def _k15_inputs(n_kf, n_lm, O, case):
    rng = np.random.default_rng(O + n_kf)
    kf = rng.integers(0, n_kf, O).astype(np.int32)
    if case == "kf_without_obs":
        kf[kf == 5] = 6
    if case == "sorted":
        kf = np.sort(kf)
    if case == "prunemap_like":
        kf = np.sort(kf)
        late = rng.permutation(rng.choice(O, O // 20, replace=False))
        kf = np.concatenate([np.delete(kf, late), kf[late]])
    lm = rng.integers(0, n_lm, O).astype(np.int32)
    mask = (rng.random(O) < 0.8).astype(np.float32)
    if case == "no_live_obs":
        mask[:] = 0
    if case == "fractional_mask":
        mask = rng.choice(np.float32([-0.5, 0, 0.3, 1, 1.7, 2]), O)
    return kf, lm, mask


@pytest.mark.parametrize("n_kf,n_lm,O,case", K15_CASES, ids=[c[3] for c in K15_CASES])
def test_redundancy_values_matches_plain(dev, n_kf, n_lm, O, case):
    from covins_tpu_torch.ops import covisibility

    args = [torch.from_numpy(x).to(dev) for x in _k15_inputs(n_kf, n_lm, O, case)]
    before = covisibility.redundancy_values.launches
    got = covisibility.redundancy_values(*args, n_kf, n_lm)
    again = covisibility.redundancy_values(*args, n_kf, n_lm)
    assert covisibility.redundancy_values.launches == before + 2
    want = covisibility.redundancy_values_plain(*[a.cpu() for a in args], n_kf, n_lm)
    assert got.dtype == torch.float32 and got.shape == (n_kf,)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    # the plain version gives the same bits on the card
    on_card = covisibility.redundancy_values_plain(*args, n_kf, n_lm)
    assert torch.equal(on_card.cpu().view(torch.int32), want.view(torch.int32))


def test_redundancy_values_refuses_bad_inputs(dev):
    from covins_tpu_torch.ops import covisibility

    kf = torch.zeros(8, dtype=torch.int32, device=dev)
    mask = torch.ones(8, dtype=torch.float32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        covisibility.redundancy_values(kf, kf.cpu(), mask, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        covisibility.redundancy_values(kf.cpu(), kf, mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.redundancy_values(kf.long(), kf, mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.redundancy_values(kf, kf, mask.bool(), 2, 2)
    with pytest.raises(ValueError):
        covisibility.redundancy_values(kf, kf[:4], mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.redundancy_values(kf, kf, mask, 2, 0)


# K17: (n_kf, n_lm, O, n_culled, edges, views, order) — the server phase's
# snapshot (152 live of 160 keyframes, a landmark seen by 17), a long
# session (1,024 keyframes, 200,000 landmarks, 1,000,000 observations),
# duplicated observations with repeated queries and a query without a live
# observation, a single keyframe, wide maps (33,000 and 40,000 keyframes),
# no observation; the server's snapshot with its observations shuffled (no
# keyframe runs: warps of many keyframes add bit by bit), and 1,100 queries
# (two passes of the bitmap) with keyframes repeated in other bitmap words
# (`synthetic.covis_repeats`)
K17_CASES = [(160, 27_441, 101_712, 8, False, 17, "runs"),
             (1024, 200_000, 1_000_000, 0, False, None, "runs"),
             (160, 27_441, 101_712, 8, True, 17, "runs"), (1, 50, 300, 0, False, None, "runs"),
             (40_000, 30_000, 120_000, 4, True, None, "runs"),
             (33_000, 500, 2_000, 0, False, None, "runs"), (12, 40, 0, 0, False, None, "runs"),
             (160, 27_441, 101_712, 8, False, 17, "shuffled"),
             (1100, 20_000, 110_000, 0, False, None, "repeats")]


@pytest.mark.parametrize("n_kf,n_lm,O,n_culled,edges,views,order", K17_CASES,
                         ids=[f"kf{c[0]}-lm{c[1]}-obs{c[2]}{'-edges' if c[4] else ''}"
                              f"{'' if c[6] == 'runs' else '-' + c[6]}" for c in K17_CASES])
def test_covis_weights_matches_plain(dev, n_kf, n_lm, O, n_culled, edges, views, order):
    from covins_tpu_torch.ops import covisibility
    from covins_tpu_torch.utils.synthetic import covis_repeats, covis_scene

    rng = np.random.default_rng(n_kf + O)
    if O:
        q, kf, lm, mask = covis_scene(rng, n_kf, n_lm, O, n_culled, edges, views)
    else:
        q, kf, lm, mask = (np.arange(n_kf, dtype=np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), np.zeros(0, bool))
    if n_kf > 30_000:  # 48 rows of the wide map, the culled keyframe's last
        q = np.concatenate([q[rng.choice(len(q) - 1, 47, replace=False)], q[-1:]])
    if order == "shuffled":
        perm = rng.permutation(len(kf))
        kf, lm, mask = kf[perm], lm[perm], mask[perm]
    if order == "repeats":
        q = covis_repeats(q)
    cpu = [torch.from_numpy(x) for x in (q, kf, lm, mask)]
    args = [x.to(dev) for x in cpu]
    before = covisibility.covis_weights_batch.launches
    got = covisibility.covis_weights_batch(*args, n_kf, n_lm)
    again = covisibility.covis_weights_batch(*args, n_kf, n_lm)
    assert covisibility.covis_weights_batch.launches == before + 2
    want = covisibility.covis_weights_batch_plain(*args, n_kf, n_lm)
    assert got.dtype == torch.int32 and got.shape == (len(q), n_kf)
    assert torch.equal(got, again) and torch.equal(got, want)
    if O <= 200_000:
        assert torch.equal(got.cpu(), covisibility.covis_weights_batch_plain(*cpu, n_kf, n_lm))
    if O and n_kf > 1:
        assert got.max() > 0
    if edges:
        assert not got[-1].any()  # the culled keyframe's row
    one = covisibility.covis_weights_for(int(q[0]), *args[1:], n_kf, n_lm)
    assert torch.equal(one, want[0])


def test_covis_weights_refuses_bad_inputs(dev):
    from covins_tpu_torch.ops import covisibility

    q = torch.zeros(4, dtype=torch.int32, device=dev)
    kf = torch.zeros(8, dtype=torch.int32, device=dev)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        covisibility.covis_weights_batch(q, kf, kf.cpu(), mask, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        covisibility.covis_weights_batch(q.cpu(), kf, kf, mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.covis_weights_batch(q.long(), kf, kf, mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.covis_weights_batch(q, kf.long(), kf, mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.covis_weights_batch(q, kf, kf, mask.float(), 2, 2)
    with pytest.raises(ValueError):
        covisibility.covis_weights_batch(q, kf, kf[:4], mask, 2, 2)
    with pytest.raises(ValueError):
        covisibility.covis_weights_batch(q, kf, kf, mask, 2, 0)


# K16: (kind, k, L, N) — a ragged tree (1-3 children in random slots of 10,
# leaves at depths 1 and 2, inner nodes without children), tied children,
# k = 2 and k = 16, no descriptor and one, a bench window (12 KF x 540),
# ORBvoc.txt's shape (k = 10, L = 6, 1,111,111 nodes) x 65,536, and nodes
# wider than one round of 16 slots: k = 17 and 32, ties across rounds
# (k = 32: odd slots repeat slot 0), a ragged tree in slots of 40; a tree
# numbered out of order, k = 1 and 3; and 20,000 descriptors, more than the
# card holds warps at once, so that k <= 16 takes the instance of 32 // k
# descriptors a warp, on ragged, tied, shuffled and k 1, 3 and 16 trees
K16_CASES = [("ragged", 10, 8, 3001), ("ties", 10, 3, 2000), ("complete", 2, 8, 1000),
             ("complete", 16, 3, 5000), ("ragged", 16, 4, 777), ("complete", 10, 3, 0),
             ("complete", 10, 3, 1), ("complete", 10, 6, 6480), ("complete", 10, 6, 65536),
             ("complete", 17, 3, 3000), ("complete", 32, 3, 4000), ("ties", 32, 2, 2000),
             ("ragged", 40, 4, 1500), ("shuffled", 10, 4, 4000), ("complete", 3, 5, 999),
             ("complete", 1, 3, 100), ("ragged", 10, 8, 20000), ("ties", 10, 3, 20000),
             ("complete", 3, 5, 20000), ("complete", 16, 3, 20000), ("complete", 1, 3, 20000),
             ("shuffled", 10, 4, 20000)]


@pytest.mark.parametrize("kind,k,L,N", K16_CASES,
                         ids=[f"{c[0]}-k{c[1]}-L{c[2]}-N{c[3]}" for c in K16_CASES])
def test_dbow_descend_matches_plain(dev, kind, k, L, N):
    from covins_tpu_torch.ops import dbow_import as dbi
    from covins_tpu_torch.utils.synthetic import dbow_descriptors, dbow_tree

    rng = np.random.default_rng(k * 1000 + L + N)
    voc = dbow_tree(rng, k, L, kind)
    descs = torch.from_numpy(dbow_descriptors(rng, voc, N))
    mask = torch.from_numpy(rng.random(N) < 0.8)
    tree, cpu_tree = voc.tree_on(dev), voc.tree_on(torch.device("cpu"))
    blocks = voc.blocks_on(dev)
    for m in (None, mask):
        d, md = descs.to(dev), None if m is None else m.to(dev)
        before = dbi.dbow_descend.launches
        got = dbi.dbow_descend(d, md, *tree, L, blocks=blocks)
        again = dbi.dbow_descend(d, md, *tree, L)  # the table built in the call
        assert dbi.dbow_descend.launches == before + (2 if N else 0)
        want = dbi.dbow_descend_plain(descs, m, *cpu_tree, L)
        on_card = dbi.dbow_descend_plain(d, md, *tree, L)
        for g, a, w, c in zip(got, again, want, on_card):
            assert g.shape == (N,) and g.dtype == w.dtype
            bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
            assert torch.equal(bits(g), bits(a)) and torch.equal(bits(g.cpu()), bits(w))
            assert torch.equal(bits(c.cpu()), bits(w))
        if m is not None and N:
            assert (got[0].cpu()[~m] == -1).all() and (got[1].cpu()[~m] == 0).all()
    if kind == "ragged":
        assert (want[0] == -1).sum() > (~mask).sum()  # descents that end on inner nodes
    # HierVocabulary.assign on the card: one launch, the same words
    before = dbi.dbow_descend.launches
    w, wt = voc.assign(descs.numpy(), mask.numpy())
    assert w.device == dev and dbi.dbow_descend.launches == before + (1 if N else 0)
    assert torch.equal(w.cpu(), want[0]) and torch.equal(wt.cpu().view(torch.int32),
                                                          want[1].view(torch.int32))


def test_dbow_descend_refuses_bad_inputs(dev):
    from covins_tpu_torch.ops import dbow_import as dbi
    from covins_tpu_torch.utils.synthetic import dbow_tree

    voc = dbow_tree(np.random.default_rng(0), 4, 2)
    ch, nd, nw, lw = voc.tree_on(dev)
    d = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        dbi.dbow_descend(d.cpu(), None, ch, nd, nw, lw, 2)
    with pytest.raises(ValueError, match=f"k <= {dbi.MAX_BRANCHING}"):
        wide = torch.full((nd.shape[0], dbi.MAX_BRANCHING + 1), -1, dtype=torch.int32,
                          device=dev)
        dbi.dbow_descend(d, None, wide, nd, nw, lw, 2)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(8 * 32 + 1, dtype=torch.uint8, device=dev)[1:].view(8, 32)
        dbi.dbow_descend(shifted, None, ch, nd, nw, lw, 2)
    with pytest.raises(ValueError):
        dbi.dbow_descend(d.int(), None, ch, nd, nw, lw, 2)
    with pytest.raises(ValueError):
        dbi.dbow_descend(d, torch.ones(7, dtype=torch.bool, device=dev), ch, nd, nw, lw, 2)
    with pytest.raises(ValueError):
        dbi.dbow_descend(d, None, ch.long(), nd, nw, lw, 2)
    blocks = voc.blocks_on(dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        dbi.dbow_descend(d, None, ch, nd, nw, lw, 2, blocks=blocks.to("cpu"))
    with pytest.raises(ValueError):
        dbi.dbow_descend(d, None, ch, nd, nw, lw, 2, blocks=blocks._replace(nxt=blocks.nxt[:, :3]))
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.zeros(blocks.rows.numel() + 1, dtype=torch.uint8, device=dev)[1:]
        dbi.dbow_descend(d, None, ch, nd, nw, lw, 2,
                         blocks=blocks._replace(rows=shifted.view(blocks.rows.shape)))
