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
Tolerances: K1 and K2 exactly (integer results); K3's word counts exactly
and its vectors bit for bit (integer counts, IEEE sqrt and division); K4
exactly; K5's matches and distances exactly (its float64 gates are built
without FMA contraction, as the plain version's separate operations
round); K6's counts, best pose and inlier mask exactly, except for a
correspondence within 1e-12 rad of the threshold; K7 to 1e-12 relative
and bit for bit between two launches; K8 and K10 to 1e-13 relative, K9
to 1e-13 of the sums of magnitudes behind each output (a landmark seen
once or twice has a nearly singular Hll, so its terms cancel), all
float64, built without FMA contraction, summing each landmark's
observations in the plain version's order (K9's keyframe sums in fixed
chunks of consecutive observations, then the chunks in order) and rounded
apart only where PyTorch's library products sum another way; bit for bit
between two launches; K8's validity and outlier decisions exactly.  The
two PCG kernels (a Gauss-Newton step's whole loop per launch) within 10x
the largest of their plain loop's own changes under three rounding
differences (one ulp added to b, one ulp taken off, its dot products
summed in another order), at ragged sizes (two poses, five keyframes,
landmarks seen 0, 1 and 2 times, visual only, no loop edge, 0, 1 and full
iteration counts) and on a pose graph whose edges all weigh 100, and bit
for bit between two launches.
"""

import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import bow, descriptors, landmark_ops, pgo, pnp, projmatch


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


def test_bow_insert_refuses_bad_inputs(dev):
    words = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    db = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int32, device=dev), db)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int64, device=dev),
                       db.double())


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


def _gated_inputs(rng, L, F, dev):
    uv = rng.uniform(0, 100, (L, 2))
    kp_uv = rng.uniform(0, 100, (F, 2))
    kp_uv[: min(L, F)] = uv[: min(L, F)] + rng.normal(scale=2.0, size=(min(L, F), 2))
    kp_uv[F // 2:] = kp_uv[: F - F // 2]  # duplicated features: ties in f
    lm_desc, kp_desc = _desc(rng, L), _desc(rng, F)
    kp_desc[: min(L, F)] = lm_desc[: min(L, F)]
    lm_desc[L // 3:] = lm_desc[: L - L // 3]  # duplicated landmarks: conflicts
    kp_oct = rng.integers(0, 4, F).astype(np.float64)
    arrays = (uv, rng.random(L) > 0.1, rng.integers(0, 5, L).astype(np.float64),
              rng.random(L) > 0.5, lm_desc, kp_uv, kp_oct, 4.0 * 2.0 ** kp_oct,
              rng.random(F) > 0.1, kp_desc)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]


@pytest.mark.parametrize("L,F", [(1, 1), (37, 70), (1024, 1024), (3001, 257)])
def test_project_match_kernel_matches_plain(dev, L, F):
    rng = np.random.default_rng(L + F)
    args = _gated_inputs(rng, L, F, dev)
    before = projmatch.gated_match.launches
    feat, dist = projmatch.gated_match(*args, 50.0)
    assert projmatch.gated_match.launches == before + 1
    rfeat, rdist = projmatch.gated_match_plain(*args, 50.0)
    assert torch.equal(feat, rfeat)
    assert torch.equal(dist, rdist)
    assert int((feat >= 0).sum()) > 0 or L < 4


@pytest.mark.parametrize("H,N", [(1, 3), (37, 100), (1200, 1024)])
def test_p3p_score_kernel_matches_plain(dev, H, N):
    rng = np.random.default_rng(H + N)
    q = rng.normal(size=(H, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([q, 0.1 * rng.normal(size=(H, 3))], 1)
    T[H // 2:] = T[: H - H // 2]  # tied counts: the first maximum wins
    P = rng.normal(size=(N, 3)) + [0, 0, 5]
    B = rng.normal(size=(N, 3)) + [0, 0, 3]
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    args = [torch.from_numpy(x).to(dev) for x in
            (T, P, B, rng.random(N) > 0.1, rng.random(H) > 0.2)]
    before = pnp.p3p_score.launches
    counts, best, inl, n_inl = pnp.p3p_score(*args, 0.6)
    assert pnp.p3p_score.launches == before + 1
    rcounts, rbest, rinl, rn = pnp.p3p_score_plain(*args, 0.6)
    assert torch.equal(counts, rcounts)
    assert int(best) == int(rbest) and int(n_inl) == int(rn)
    assert torch.equal(inl, rinl)


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


@pytest.mark.parametrize("F,S", [(1, 1), (7, 50), (255, 256)])
def test_imu_preintegrate_kernel_matches_plain(dev, F, S):
    from covins_tpu_torch.ops import imu

    rng = np.random.default_rng(F + S)
    acc = rng.normal(size=(F, S, 3)) + [0.0, 0.0, 9.81]
    gyro = 0.5 * rng.normal(size=(F, S, 3))
    dts = np.full((F, S), 0.005)
    mask = (np.arange(S)[None, :] < rng.integers(1, S + 1, F)[:, None]).astype(np.float64)
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
    for mode in ("cost", "outlier"):
        val, valid = gba.reproj_blocks(pd, gd, huber, mode)
        rval, rvalid = gba.reproj_blocks_plain(pd, gd, huber, mode)
        assert torch.equal(valid, rvalid) and not bool(valid.all())
        assert _rel(val, rval) <= 1e-13
    # the outlier decision at the threshold is the plain version's
    val, valid = gba.reproj_blocks(pd, gd, 0.0, "outlier")
    cval, cvalid = gba.reproj_blocks(pc, gc, 0.0, "outlier")
    assert torch.equal((val < 0.92).cpu(), cval < 0.92)


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
    """One Gauss-Newton step launches the PCG kernel once and K9 seven times
    (b_red and the six ladder scales), never inside the PCG."""
    from covins_tpu_torch.ops import gba

    _, g, pd = _gba_system(dev)
    before = (gba.pcg.launches, gba.reduced_matvec.launches)
    gba._gn_schur_step(pd, g, (pd.poses, pd.vels, pd.biases, pd.lms),
                       torch.tensor(1e-4, dtype=torch.float64, device=dev), 60, False)
    assert (gba.pcg.launches - before[0], gba.reduced_matvec.launches - before[1]) == (1, 7)


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
