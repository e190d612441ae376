"""The block-Jacobi PCG loops of the GBA and pose-graph solves on the CPU.

On the card each Gauss-Newton step's whole PCG is one cooperative launch
(`gba.pcg`, `pgo.pcg`); `tests/test_torch_kernels_cuda.py` holds those
kernels to their plain versions.  Here, on the CPU:
* the wrappers take the plain versions (no launch is counted);
* the plain loops, now factored out as `gba.pcg_plain` and `pgo._pcg`
  behind `gba.reduced_system` and `pgo.normal_equations`, give bit for bit
  what `_gn_schur_step` and `optimize_pose_graph` computed with the loops
  inline (copies of the inline versions below) on the JAX package's GBA
  problem (`tests/test_gba.py:_build_problem`, with a loop edge) and a
  synthetic pose graph;
* the plain loops take the plain matvec and another summation order, as
  the card's yardstick of the kernels uses them
  (`chip_smoke.rounding_readings`), and the reduced system is what the GBA
  PCG kernel reads (contiguous float64 blocks, int32 factor endpoints);
* every index structure the kernels read (the landmark CSR, the chunk
  layout of the keyframe sums, the loop-edge and IMU node CSRs, the pose
  graph's node CSR) sums, through a gather in its fixed order, to exactly
  the plain version's index_add (integer values, so any order is exact),
  and lists each node's i ends in factor order before its j ends.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import gba, linalg, pgo
from covins_tpu_torch.state import gba_problem_from_reference
from covins_tpu_torch.utils import geometry as geo
from covins_tpu_torch.utils import synthetic

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_gba import _build_problem  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    rp, traj, _ = _build_problem()
    from covins_tpu.utils import geometry as ref_geo
    T = ref_geo.pose_relative(traj.poses[2], traj.poses[9])
    rp = dataclasses.replace(
        rp, loop_i=jnp.asarray([2], jnp.int32), loop_j=jnp.asarray([9], jnp.int32),
        loop_T=T[None], loop_sqrt_info=jnp.diag(jnp.asarray([100.0] * 3 + [1e4] * 3))[None],
        loop_mask=jnp.asarray([True]))
    return gba_problem_from_reference(rp, device="cpu")


@pytest.fixture(scope="module")
def pose_graph():
    g, _ = synthetic.build_pose_graph(n_kf=40, n_loops=3, seed=3, drift=0.02,
                                      device="cpu")
    return g


# ------------------------------------------------ the loops as they were
def _gn_schur_step_inline(p, graph, state, lam, n_cg, visual_only, huber_k):
    """`gba._gn_schur_step` with its `fused` PCG inline, as it was before
    the loop moved into `gba.pcg_plain`."""
    poses, vels, biases, lms = state
    pp = gba._with_state(p, state)
    n = poses.shape[0]
    dtype = poses.dtype
    free_pose = (~p.kf_fixed & p.kf_mask).to(dtype)[:, None]
    free_vb = p.kf_mask.to(dtype)[:, None]
    free = torch.cat([free_pose.expand(n, 6), free_vb.expand(n, 9)], dim=-1)
    lm_free = p.lm_mask.to(dtype)[:, None]
    r_o, Jp_o, Jl_o, b6, M6, b_l, Hll = gba.reproj_blocks(pp, graph, huber_k, "linearize")
    r_l, Ji_l, Jj_l = gba._loop_r_J(pp)
    if not visual_only:
        r_f, J_f = gba._imu_r_J(pp)
        Ji_f, Jj_f = J_f[:, :, :15], J_f[:, :, 15:]
    b6 = b6.index_add(0, p.loop_i, -gba._bt(Ji_l, r_l)).index_add(
        0, p.loop_j, -gba._bt(Jj_l, r_l))
    b_p = gba._pad15(b6)
    if not visual_only:
        b_p = b_p.index_add(0, p.imu_i, -gba._bt(Ji_f, r_f)).index_add(
            0, p.imu_j, -gba._bt(Jj_f, r_f))
    b_p = b_p * free
    b_l = b_l * lm_free
    eye3 = torch.eye(3, dtype=dtype)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll = Hll + lam * dll[..., None] * eye3 + 1e-10 * eye3
    Hll_inv = (linalg.inv33(Hll) * lm_free[..., None]).contiguous()
    M6 = M6.index_add(0, p.loop_i, Ji_l.transpose(-1, -2) @ Ji_l).index_add(
        0, p.loop_j, Jj_l.transpose(-1, -2) @ Jj_l)
    M_blocks = gba._pad15(M6)
    if not visual_only:
        M_blocks = M_blocks.index_add(0, p.imu_i, Ji_f.transpose(-1, -2) @ Ji_f).index_add(
            0, p.imu_j, Jj_f.transpose(-1, -2) @ Jj_f)
    dpp = torch.diagonal(M_blocks, dim1=-2, dim2=-1)
    lam_diag = lam * dpp + 1e-8
    M_inv = linalg.inv_psd_small(M_blocks + torch.diag_embed(lam_diag))

    def hpp_factors(v, out6):
        v6 = v[:, :6]
        y_l = (Ji_l @ v6[p.loop_i][..., None])[..., 0] + (Jj_l @ v6[p.loop_j][..., None])[..., 0]
        out6 = out6.index_add(0, p.loop_i, gba._bt(Ji_l, y_l)).index_add(
            0, p.loop_j, gba._bt(Jj_l, y_l))
        out = gba._pad15(out6)
        if not visual_only:
            y_f = (Ji_f @ v[p.imu_i][..., None])[..., 0] + (Jj_f @ v[p.imu_j][..., None])[..., 0]
            out = out.index_add(0, p.imu_i, gba._bt(Ji_f, y_f)).index_add(
                0, p.imu_j, gba._bt(Jj_f, y_f))
        return out

    def reduced_Hv(v):
        v = v * free
        obs6 = gba.reduced_matvec(v[:, :6].contiguous(), None, Jp_o, Jl_o, Hll_inv, graph, n)
        return hpp_factors(v, obs6) * free + lam_diag * v

    b_red = (b_p + gba._pad15(gba.reduced_matvec(None, b_l.contiguous(), Jp_o, Jl_o,
                                                 Hll_inv, graph, n))) * free

    def apply_M(r):
        return (M_inv @ r[..., None])[..., 0] * free

    r = b_red
    u = apply_M(r)
    w = reduced_Hv(u)
    gamma = torch.sum(r * u)
    alpha = gba._safe_div(gamma, torch.sum(w * u))
    x = torch.zeros_like(b_red)
    pvec, svec = u, w
    for _ in range(n_cg):
        x = x + alpha * pvec
        r = r - alpha * svec
        u = apply_M(r)
        w = reduced_Hv(u)
        gamma1 = torch.sum(r * u)
        delta1 = torch.sum(w * u)
        beta1 = gba._safe_div(gamma1, gamma)
        alpha = gba._safe_div(gamma1, delta1 - gba._safe_div(beta1 * gamma1, alpha))
        pvec = u + beta1 * pvec
        svec = w + beta1 * svec
        gamma = gamma1
    dx_p = x * free

    def state_at(a):
        dxp = a * dx_p
        t = gba.reduced_matvec(dxp[:, :6].contiguous(), None, Jp_o, Jl_o, Hll_inv, graph,
                               n, t_only=True)
        dxl = (Hll_inv @ (b_l - t)[..., None])[..., 0] * lm_free
        return (geo.pose_boxplus(poses, dxp[:, :6]), vels + dxp[:, 6:9],
                biases + dxp[:, 9:15], lms + dxl)

    cands = [state_at(a) for a in gba.LADDER]
    costs = torch.stack([gba.total_cost(p, graph, st, visual_only, huber_k) for st in cands])
    best = torch.argmin(costs)
    c_best = costs[best]
    c_old = gba.total_cost(p, graph, state, visual_only, huber_k)
    accept = c_best < c_old
    pick = best.reshape(1)
    out = tuple(torch.where(accept, torch.index_select(torch.stack(cs), 0, pick)[0], old)
                for cs, old in zip(zip(*cands), state))
    lam_new = torch.where(accept, torch.where(best == 0, lam / 3.0, lam * 2.0), lam * 10.0)
    return out, torch.clamp(lam_new, 1e-12, 1e8), torch.minimum(c_best, c_old)


def _optimize_pose_graph_inline(g, n_gn, n_cg, damping=1e-6, cauchy_scale=0.0):
    """`pgo.optimize_pose_graph` with its linearisation inline and `_pcg`
    called on a matvec closure, as it was before `pgo.pcg`."""
    from covins_tpu_torch.ops import residuals as res

    n = g.poses.shape[0]
    dt = g.poses.dtype
    free = (~g.fixed & g.pose_mask).to(dt)
    eye = torch.eye(6, dtype=dt)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, n)
    poses = g.poses
    cost = None
    for _ in range(n_gn):
        r, Ji, Jj = pgo._edge_residual_jac(poses, g)
        w = g.edge_mask.to(dt)
        if cauchy_scale > 0:
            cw = res.cauchy_weight(torch.sum(r * r, dim=-1), cauchy_scale)
            w = w * torch.where(g.edge_is_loop, cw, 1.0)
        sw = torch.sqrt(w)[:, None]
        r_w = r * sw
        Ji_w = (Ji * sw[..., None]).contiguous()
        Jj_w = (Jj * sw[..., None]).contiguous()
        bi = -torch.einsum("eri,er->ei", Ji_w, r_w)
        bj = -torch.einsum("eri,er->ei", Jj_w, r_w)
        b = (torch.zeros((n, 6), dtype=dt).index_add_(0, g.edge_i, bi)
             .index_add_(0, g.edge_j, bj)) * free[:, None]
        Pi = torch.einsum("eri,erj->eij", Ji_w, Ji_w)
        Pj = torch.einsum("eri,erj->eij", Jj_w, Jj_w)
        M = (torch.zeros((n, 6, 6), dtype=dt).index_add_(0, g.edge_i, Pi)
             .index_add_(0, g.edge_j, Pj)) + (damping + 1e-9) * eye
        Minv = linalg.inv_psd_small(M)

        def Hv(v):
            return pgo.matvec(v, free, Ji_w, Jj_w, graph, damping)

        dx = pgo._pcg(Hv, b, Minv, free, n_cg) * free[:, None]
        poses_new = geo.pose_boxplus(poses, dx)
        r_new = pgo._edge_residual(poses_new, g)
        c_old = torch.sum(w * torch.sum(r * r, -1))
        c_new = torch.sum(w * torch.sum(r_new * r_new, -1))
        poses = torch.where(c_new < c_old, poses_new, poses)
        cost = torch.minimum(c_new, c_old)
    return poses, cost


# ----------------------------------------------------------------- tests
SCENARIOS = {"clean": (0.0, False), "huber": (2.447, False), "visual_only": (0.0, True)}


@pytest.mark.parametrize("n_cg", [0, 1, 60])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_gn_schur_step_equals_inline_loop(problem, scenario, n_cg):
    huber, visual_only = SCENARIOS[scenario]
    p = problem
    graph = gba.obs_graph(p)
    state = (p.poses, p.vels, p.biases, p.lms)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    before = gba.pcg.launches
    got = gba._gn_schur_step(p, graph, state, lam, n_cg, visual_only, huber)
    assert gba.pcg.launches == before
    want = _gn_schur_step_inline(p, graph, state, lam, n_cg, visual_only, huber)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("visual_only", [False, True])
def test_gba_pcg_wrapper_takes_plain_version_on_cpu(problem, visual_only):
    p = problem
    graph = gba.obs_graph(p)
    s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64), visual_only)
    before = gba.pcg.launches
    x = gba.pcg(s, graph, 20)
    assert gba.pcg.launches == before
    assert torch.equal(x, gba.pcg_plain(s, graph, 20))
    assert torch.equal(gba.pcg(s, graph, 0), torch.zeros_like(s.b_red))
    # the solve lowers the quadratic model: x^T H x / 2 - b^T x < 0
    Hx = gba.reduced_Hv(s, graph, x)
    assert float(0.5 * torch.sum(x * Hx) - torch.sum(s.b_red * x)) < 0.0


@pytest.mark.parametrize("cauchy", [0.0, 0.5])
def test_optimize_pose_graph_equals_inline_loop(pose_graph, cauchy):
    before = (pgo.pcg.launches, pgo.matvec.launches)
    got = pgo.optimize_pose_graph(pose_graph, n_gn=3, n_cg=100, cauchy_scale=cauchy)
    assert (pgo.pcg.launches, pgo.matvec.launches) == before
    want = _optimize_pose_graph_inline(pose_graph, 3, 100, cauchy_scale=cauchy)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the loops moved the drifted start
    assert float((got[0] - pose_graph.poses).abs().max()) > 1e-3


def test_pgo_pcg_wrapper_takes_plain_version_on_cpu(pose_graph):
    g = pose_graph
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, g.poses.shape[0])
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)
    before = pgo.pcg.launches
    x = pgo.pcg(b, Minv, free, Ji, Jj, graph, 1e-6, 40)
    assert pgo.pcg.launches == before
    want = pgo._pcg(lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6), b, Minv,
                    free, 40)
    assert torch.equal(x, want)
    assert torch.equal(pgo.pcg(b, Minv, free, Ji, Jj, graph, 1e-6, 0), torch.zeros_like(b))


def _reversed_total(x):
    return torch.cumsum(x.reshape(-1).flip(0), 0)[-1]


def _counting(total, calls):
    def counted(x):
        calls.append(x.shape)
        return total(x)
    return counted


@pytest.mark.parametrize("visual_only", [False, True])
def test_gba_plain_loop_takes_plain_matvec_and_another_sum(problem, visual_only):
    p = problem
    graph = gba.obs_graph(p)
    s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64), visual_only)
    want = gba.pcg_plain(s, graph, 20)
    calls = []
    got = gba.pcg_plain(s, graph, 20, gba.reduced_matvec_plain, _counting(torch.sum, calls))
    assert torch.equal(got, want)
    assert len(calls) == 2 + 2 * 20
    # another summation order is a rounding difference, which this stiff
    # system amplifies by up to 1e-2 of the result after 20 iterations
    moved = gba.pcg_plain(s, graph, 20, gba.reduced_matvec_plain, _reversed_total)
    assert bool(torch.isfinite(moved).all()) and not torch.equal(moved, want)


def test_pgo_plain_loop_takes_another_sum(pose_graph):
    g = pose_graph
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, g.poses.shape[0])
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)

    def Hv(v):
        return pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6)
    want = pgo._pcg(Hv, b, Minv, free, 40)
    calls = []
    assert torch.equal(pgo._pcg(Hv, b, Minv, free, 40, _counting(torch.sum, calls)), want)
    assert len(calls) == 2 + 2 * 40
    moved = pgo._pcg(Hv, b, Minv, free, 40, _reversed_total)
    assert bool(torch.isfinite(moved).all()) and not torch.equal(moved, want)


def test_rounding_readings_of_a_plain_loop(pose_graph):
    """The card's yardstick on the CPU: each of the three readings moves
    the loop, by far less than the loop's result."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    g = pose_graph
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, g.poses.shape[0])
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)

    def plain(bb, total):
        return pgo._pcg(lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6), bb, Minv,
                        free, 40, total)
    x0, readings = chip_smoke.rounding_readings(plain, b)
    assert torch.equal(x0, plain(b, torch.sum))
    assert set(readings) == {"one_ulp_up", "one_ulp_down", "reordered_sums"}
    for v in readings.values():
        assert 0.0 < v < 1e-6 * float(x0.abs().max())


@pytest.mark.parametrize("visual_only,loops", [(False, True), (True, True), (False, False)])
def test_reduced_system_is_what_the_gba_pcg_kernel_reads(problem, visual_only, loops):
    p = problem
    graph = gba.obs_graph(p)
    s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64), visual_only)
    if not loops:
        f = s.fac
        s = dataclasses.replace(s, fac=gba.factors(
            f.loop_i[:0], f.loop_j[:0], f.Ji_l[:0], f.Jj_l[:0], f.imu_i, f.imu_j, f.Ji_f,
            f.Jj_f, p.poses.shape[0]))
    n_loop, n_imu = gba._check_pcg(s, graph, 60)
    assert (n_loop, n_imu) == (1 if loops else 0, 0 if visual_only else p.imu_i.shape[0])
    f = s.fac
    for wide, narrow in ((f.loop_i, f.loop_i32), (f.loop_j, f.loop_j32),
                         (f.imu_i, f.imu_i32), (f.imu_j, f.imu_j32)):
        assert narrow.dtype == torch.int32 and torch.equal(narrow.long(), wide)
    with pytest.raises(ValueError):
        gba._check_pcg(dataclasses.replace(s, lam_diag=s.lam_diag.t().contiguous().t()),
                       graph, 60)
    with pytest.raises(ValueError):
        gba._check_pcg(s, graph, -1)


# ------------------------------------------------------ index structures
def _ints(rng, *shape):
    return torch.from_numpy(rng.integers(-1000, 1000, shape))


def _csr_gather(rowptr, entries, vals_i, vals_j):
    """Per node, the sum of its entries' values in the CSR's order (entry
    e < F takes vals_i[e], F + e takes vals_j[e])."""
    F = vals_i.shape[0]
    stacked = torch.cat([vals_i, vals_j])
    out = torch.zeros((rowptr.shape[0] - 1,) + vals_i.shape[1:], dtype=vals_i.dtype)
    for node in range(out.shape[0]):
        ent = entries[rowptr[node]:rowptr[node + 1]].long()
        out[node] = stacked[ent].sum(0)
        # i ends in factor order, then j ends in factor order
        assert torch.equal(ent, torch.sort(ent).values)
    assert entries.shape == (2 * F,)
    return out


def _node_csr_matches_index_add(i, j, rowptr, entries, n, rng):
    vi, vj = _ints(rng, i.shape[0], 6), _ints(rng, i.shape[0], 6)
    want = torch.zeros((n, 6), dtype=torch.int64).index_add_(0, i, vi).index_add_(0, j, vj)
    assert torch.equal(_csr_gather(rowptr, entries, vi, vj), want)
    np.testing.assert_array_equal(np.sort(entries.numpy()), np.arange(2 * i.shape[0]))


@pytest.mark.parametrize("n_kf,n_lm,max_obs", [(12, 150, None), (7, 60, 100), (2, 8, 3)])
def test_chunk_layout_and_landmark_csr_sum_as_index_add(n_kf, n_lm, max_obs):
    p, _, _ = synthetic.build_gba_problem(n_kf=n_kf, n_lm=n_lm, seed=n_kf, max_obs=max_obs,
                                          device="cpu")
    g = gba.obs_graph(p)
    o, n, m = p.obs_kf.shape[0], n_kf, p.lms.shape[0]
    rng = np.random.default_rng(n_kf)
    vals = _ints(rng, o, 6)
    kf_obs = g.kf_obs.long()
    ptr, kptr = g.chunk_ptr.long(), g.kf_chunk_ptr.long()
    ckf = torch.repeat_interleave(torch.arange(n), kptr[1:] - kptr[:-1])  # chunk -> keyframe
    # chunks tile kf_obs in order, each within one keyframe's row
    assert int(ptr[0]) == 0 and int(ptr[-1]) == o and bool((ptr[1:] > ptr[:-1]).all())
    assert bool(((ptr[1:] - ptr[:-1]) <= gba.KF_CHUNK).all())
    assert torch.equal(p.obs_kf[kf_obs[ptr[:-1]]], ckf)
    assert torch.equal(p.obs_kf[kf_obs[ptr[1:] - 1]], ckf)
    assert g.n_chunks == ckf.shape[0]
    part = torch.stack([vals[kf_obs[ptr[c]:ptr[c + 1]]].sum(0) for c in range(ckf.shape[0])]) \
        if ckf.shape[0] else torch.zeros((0, 6), dtype=torch.int64)
    got = torch.stack([part[kptr[k]:kptr[k + 1]].sum(0) for k in range(n)])
    want = torch.zeros((n, 6), dtype=torch.int64).index_add_(0, p.obs_kf, vals)
    assert torch.equal(got, want)
    # the landmark CSR of the landmark pass
    lr, lo = g.lm_rowptr.long(), g.lm_obs.long()
    got = torch.stack([vals[lo[lr[l]:lr[l + 1]]].sum(0) for l in range(m)])
    want = torch.zeros((m, 6), dtype=torch.int64).index_add_(0, p.obs_lm, vals)
    assert torch.equal(got, want)
    for rowptr, order, keys in ((lr, lo, p.obs_lm), (g.kf_rowptr.long(), kf_obs, p.obs_kf)):
        for row in range(rowptr.shape[0] - 1):
            ids = order[rowptr[row]:rowptr[row + 1]]
            assert bool((keys[ids] == row).all()) and torch.equal(ids, torch.sort(ids).values)


@pytest.mark.parametrize("visual_only", [False, True])
def test_factor_csrs_sum_as_index_add(problem, visual_only):
    p = problem
    s = gba.reduced_system(p, gba.obs_graph(p), (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64), visual_only)
    fac, n = s.fac, p.poses.shape[0]
    rng = np.random.default_rng(1)
    _node_csr_matches_index_add(fac.loop_i, fac.loop_j, fac.loop_rowptr, fac.loop_entries,
                                n, rng)
    _node_csr_matches_index_add(fac.imu_i, fac.imu_j, fac.imu_rowptr, fac.imu_entries, n, rng)
    assert (fac.imu_i.shape[0] == 0) == visual_only
    # many factors per node, with repeats
    i = torch.from_numpy(rng.integers(0, 9, 40))
    j = torch.from_numpy(rng.integers(0, 9, 40))
    f = gba.factors(i, j, fac.Ji_l[:0], fac.Jj_l[:0], i, j, None, None, 9)
    _node_csr_matches_index_add(i, j, f.loop_rowptr, f.loop_entries, 9, rng)


@pytest.mark.parametrize("n,e", [(1, 1), (9, 40), (256, 1270)])
def test_pose_graph_csr_sums_as_index_add(n, e):
    rng = np.random.default_rng(n + e)
    i = torch.from_numpy(rng.integers(0, n, e))
    j = torch.from_numpy((rng.integers(0, n, e) + 1) % n)
    graph = pgo.matvec_graph(i, j, n)
    _node_csr_matches_index_add(i, j, graph.rowptr.long(), graph.entries.long(), n, rng)
