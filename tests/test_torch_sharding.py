"""Multi-device sharding of the port (`covins_tpu_torch/parallel/sharding.py`)
against the JAX package's (`covins_tpu/parallel/sharding.py`), on the CPU.

A rank is a process.  For each world size (1, 2 and 4) the module starts
that many processes once (``torch.multiprocessing``, gloo over a
``FileStore`` in the module's temporary directory); every rank runs every
sharded check on inputs made with numpy from a seed and writes its numpy
results to a file.  The ranks import torch, numpy and the port only: JAX
runs in this process, which computes the reference (on the JAX package's
8-device CPU mesh, and unsharded) while the ranks run.

Bounds:
* retrieval: scores to 1e-6 (float32 products summed in another order),
  indices exactly; Hamming k-NN: distances and indices exactly;
* the GBA step (one LM step of 15 CG iterations on a 12-keyframe,
  96-landmark problem, `utils/synthetic.build_gba_problem`, handed to both
  packages): at world 1 bit for bit with the port's unsharded step; at
  worlds 2 and 4 within `tests/test_parallel.py`'s own bounds of the
  port's unsharded step (cost 1e-8 relative, states 1e-9), and within
  GBA_FACTOR times the step's measured one-ulp spread of the reference's
  step (the port's step is itself that far from the reference: the reduced
  system is ill-conditioned and its PCG stops far from convergence, see
  `tests/test_torch_gba.py`);
* the pose graph (`utils/synthetic.chain_pose_graph`, the dry run's
  32-pose chain, 5 Gauss-Newton steps of 200 CG iterations): at world 1 bit
  for bit with the port's unsharded solve; at worlds 2 and 4 within
  GBA_FACTOR times the solve's measured one-ulp spread of the unsharded
  solve and of the reference's, and within 1e-4 of the ground truth;
* the collectives of a sharded GBA step: exactly n_cg + 3 all-reduces with
  the fused PCG, n_cg + 2 with the classic one, nothing else;
* padding (`pad_to_multiple`, `shard_pose_graph`'s): the states bit for
  bit, the costs to 1e-12 relative (a sum over more zero terms rounds in
  other blocks).

The spreads are read by the ranks themselves: the port's unsharded step
or solve with its landmarks or poses moved by one ulp either way, against
the unmoved one.
"""

import concurrent.futures
import dataclasses
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from covins_tpu_torch.ops import bow, gba, pgo
from covins_tpu_torch.parallel import sharding as sh
from covins_tpu_torch.utils import synthetic

GBA_FACTOR = 10.0
N_CG = 15
COUNT_CG = 2  # the CG iterations of count_collectives' steps
WORLDS = (1, 2, 4)
# the spreads' readings: (what moves, direction), one a rank of world 4
GBA_ULPS = (("lms", 1.0), ("lms", -1.0), ("poses", 1.0), ("poses", -1.0))
PGO_ULPS = (1.0, -1.0)  # the chain's start poses, one a rank of world 2
RUN_TIMEOUT_S = 600


def _inputs():
    """Everything the ranks and the reference take, numpy from seeds."""
    rng = np.random.default_rng(0)
    db = rng.random((512, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    tied = db.copy()
    tied[[100, 300, 301]] = tied[37]  # three rows tie with the query's own
    few = np.zeros(512, bool)
    few[[5, 200, 411]] = True  # three valid rows, k above that
    retrieval = {"plain": (db, db[37], np.ones(512, bool), 5),
                 "ties": (tied, tied[37], np.ones(512, bool), 5),
                 "masked": (tied, tied[37], few, 8)}
    u8 = np.random.default_rng(1).integers(0, 256, (256, 32)).astype(np.uint8)
    u8[[70, 140, 250]] = u8[3]  # query 3 at distance 0 from four rows
    u8[[9, 200]] = u8[10]
    p, _, _ = synthetic.build_gba_problem(n_kf=12, n_lm=96, seed=0, device="cpu")
    g, gt = synthetic.chain_pose_graph(32, seed=1, device="cpu")
    return {"retrieval": retrieval, "knn": u8, "gba": p, "pgo": (g, gt)}


# --------------------------------------------------------------------- ranks
def _moved(x, direction):
    return torch.nextafter(x, torch.full_like(x, direction * float("inf")))


def _gba_step(p):
    lam = torch.tensor(1e-4, dtype=torch.float64)
    st, lam, cost = gba._gn_schur_step(p, gba.obs_graph(p), (p.poses, p.vels, p.biases, p.lms),
                                       lam, N_CG, False)
    return {"state": [x.numpy() for x in st], "lam": float(lam), "cost": float(cost)}


def _sharded_step(mesh, p, multiple=None):
    shard = sh.shard_gba_problem(mesh, sh.pad_to_multiple(p, multiple or mesh.world))
    lam = torch.tensor(1e-4, dtype=torch.float64)
    st, lam, cost = sh.gba_step_sharded(mesh, shard, shard.state(), lam, N_CG)
    lms = sh.gather_landmarks(mesh, shard, st[3])
    return {"state": [x.numpy() for x in st[:3]] + [lms.numpy()], "lam": float(lam),
            "cost": float(cost)}


def _pgo(g):
    poses, cost = pgo.optimize_pose_graph(g, n_gn=5, n_cg=200)
    return {"poses": poses.numpy(), "cost": float(cost)}


def _sharded_pgo(mesh, g, multiple=None):
    poses, cost = sh.optimize_pose_graph_sharded(mesh, sh.shard_pose_graph(mesh, g,
                                                                           multiple=multiple),
                                                 n_gn=5, n_cg=200)
    return {"poses": poses.numpy(), "cost": float(cost)}


def _rank_main(rank, world, store, out_dir, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = sh.make_mesh(world, device="cpu")
        out = {"retrieval": {}, "knn": {}}
        for name, (db, q, mask, k) in inputs["retrieval"].items():
            s, i = sh.sharded_topk_scores(mesh, sh.shard_rows(mesh, db), sh.replicate(mesh, q),
                                          sh.shard_rows(mesh, mask), k=k)
            out["retrieval"][name] = (s.numpy(), i.numpy())
        from covins_tpu_torch.ops.descriptors import unpack_to_pm1
        pm1 = unpack_to_pm1(torch.from_numpy(inputs["knn"]))
        for k in (2, 5):
            d, i = sh.sharded_hamming_knn(mesh, sh.shard_rows(mesh, pm1),
                                          sh.replicate(mesh, pm1[:16]), k=k)
            out["knn"][k] = (d.numpy(), i.numpy())
        p = inputs["gba"]
        g, _ = inputs["pgo"]
        out["gba"] = _sharded_step(mesh, p)
        out["pgo"] = _sharded_pgo(mesh, g)
        shard = sh.shard_gba_problem(mesh, p)
        for variant in ("fused", "classic"):
            out[f"count_{variant}"] = sh.count_collectives(
                mesh, shard, shard.state(), torch.tensor(1e-4, dtype=torch.float64), COUNT_CG,
                cg_variant=variant)
        # each rank's share of the unsharded runs and the spreads' readings
        if world == 1:
            out["gba_unsharded"] = _gba_step(p)
            out["pgo_unsharded"] = _pgo(g)
            out["gba_padded"] = _sharded_step(mesh, p, multiple=7)
            out["pgo_padded"] = _sharded_pgo(mesh, g, multiple=5)
        elif world == 2:
            out["pgo_ulp"] = _pgo(dataclasses.replace(g, poses=_moved(g.poses, PGO_ULPS[rank])))
        else:
            name, direction = GBA_ULPS[rank]
            x = getattr(p, name)
            out["gba_ulp"] = _gba_step(dataclasses.replace(p, **{name: _moved(x, direction)}))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- reference
def _jnp(t, index=False):
    import jax.numpy as jnp

    a = t.numpy()
    return jnp.asarray(a.astype(np.int32) if index else a)


def _reference_problem(p):
    """The port's GBA problem as the JAX package's, field by field."""
    from covins_tpu.ops import gba as ref_gba
    from covins_tpu.ops import imu as ref_imu
    from covins_tpu.utils import cameras as ref_cam

    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "cam":
            kw["cam"] = ref_cam.Camera(_jnp(v.intrinsics), _jnp(v.dist), _jnp(v.T_s_c),
                                       v.cam_model, v.dist_model)
        elif f.name == "imu_pre":
            kw["imu_pre"] = ref_imu.Preintegrated(**{
                g.name: _jnp(getattr(v, g.name)) for g in dataclasses.fields(v)})
        else:
            kw[f.name] = _jnp(v, f.name in ("obs_kf", "obs_lm", "imu_i", "imu_j", "loop_i",
                                            "loop_j"))
    return ref_gba.GBAProblem(**kw)


def _reference(inputs):
    """The JAX package's results on the same inputs: its sharded functions
    on the 8-device mesh and unsharded, its GBA step and pose-graph solve."""
    import jax
    import jax.numpy as jnp

    from covins_tpu.ops import descriptors as ref_d
    from covins_tpu.ops import gba as ref_gba
    from covins_tpu.ops import pgo as ref_pgo
    from covins_tpu.parallel import sharding as ref_sh

    mesh = ref_sh.make_mesh(8)
    out = {"retrieval": {}, "retrieval_local": {}, "knn": {}}
    for name, (db, q, mask, k) in inputs["retrieval"].items():
        local = ref_sh.sharded_topk_scores(jnp.asarray(db), jnp.asarray(q), jnp.asarray(mask),
                                           k=k)
        with mesh:
            got = ref_sh.sharded_topk_scores(ref_sh.shard_rows(mesh, jnp.asarray(db)),
                                             ref_sh.replicate(mesh, jnp.asarray(q)),
                                             ref_sh.replicate(mesh, jnp.asarray(mask)), k=k)
        out["retrieval"][name] = tuple(np.asarray(x) for x in got)
        out["retrieval_local"][name] = tuple(np.asarray(x) for x in local)
    pm1 = ref_d.unpack_to_pm1(jnp.asarray(inputs["knn"]))
    for k in (2, 5):
        with mesh:
            got = ref_sh.sharded_hamming_knn(ref_sh.shard_rows(mesh, pm1),
                                             ref_sh.replicate(mesh, pm1[:16]), k=k)
        out["knn"][k] = tuple(np.asarray(x) for x in got)

    def gba_step():
        rp = _reference_problem(inputs["gba"])
        step = jax.jit(lambda st, lam: ref_gba._gn_schur_step(rp, st, lam, N_CG, False))
        st, lam, cost = step((rp.poses, rp.vels, rp.biases, rp.lms), jnp.asarray(1e-4))
        return {"state": [np.asarray(x) for x in st], "lam": float(lam), "cost": float(cost)}

    def pose_graph():
        g, _ = inputs["pgo"]
        rg = ref_pgo.PoseGraph(**{f.name: _jnp(getattr(g, f.name),
                                               f.name in ("edge_i", "edge_j"))
                                  for f in dataclasses.fields(g)})
        return np.asarray(ref_pgo.optimize_pose_graph(rg, n_gn=5, n_cg=200)[0])

    # the two compiles overlap in two threads
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gba_job, pgo_job = pool.submit(gba_step), pool.submit(pose_graph)
        out["gba"], out["pgo"] = gba_job.result(), pgo_job.result()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    started = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        ctx = mp.start_processes(_rank_main, args=(world, str(d / "store"), str(d), inputs),
                                 nprocs=world, join=False, start_method="spawn")
        started[world] = (ctx, d)
    try:
        ref = _reference(inputs)  # while the ranks run
        deadline = time.monotonic() + RUN_TIMEOUT_S
        for ctx, _ in started.values():
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError("the sharded ranks did not finish")
    finally:
        for ctx, _ in started.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    ranks = {w: [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(w)]
             for w, (_, d) in started.items()}
    return inputs, ref, ranks


def _max_abs(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_retrieval_matches_reference(runs, world):
    inputs, ref, ranks = runs
    for name, (db, q, mask, k) in inputs["retrieval"].items():
        for out in ranks[world]:
            s, i = out["retrieval"][name]
            for want_s, want_i in (ref["retrieval"][name], ref["retrieval_local"][name]):
                np.testing.assert_allclose(s, want_s, atol=1e-6, err_msg=name)
                np.testing.assert_array_equal(i, want_i, err_msg=name)
    # ties go to the lower index: the query's row and its three copies
    np.testing.assert_array_equal(ranks[world][0]["retrieval"]["ties"][1][:4],
                                  [37, 100, 300, 301])
    # the three valid rows, then the masked ones from the lowest index
    idx = ranks[world][0]["retrieval"]["masked"][1]
    assert sorted(idx[:3]) == [5, 200, 411]
    np.testing.assert_array_equal(idx[3:], [0, 1, 2, 3, 4])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_hamming_knn_matches_reference(runs, world):
    _, ref, ranks = runs
    for k in (2, 5):
        for out in ranks[world]:
            d, i = out["knn"][k]
            assert d.shape == (16, k) and d.dtype == np.int32
            np.testing.assert_array_equal(d, ref["knn"][k][0])
            np.testing.assert_array_equal(i, ref["knn"][k][1])
    np.testing.assert_array_equal(ranks[world][0]["knn"][5][1][3, :4], [3, 70, 140, 250])


def _gba_spread(ranks):
    base = ranks[1][0]["gba_unsharded"]
    state = max(_max_abs(r["gba_ulp"]["state"], base["state"]) for r in ranks[4])
    cost = max(_rel(r["gba_ulp"]["cost"], base["cost"]) for r in ranks[4])
    assert state > 0 and cost > 0
    return state, cost


def test_sharded_gba_step_world1_is_the_unsharded_step(runs):
    _, _, ranks = runs
    got, want = ranks[1][0]["gba"], ranks[1][0]["gba_unsharded"]
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(a, b)
    assert got["cost"] == want["cost"] and got["lam"] == want["lam"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gba_step_matches_unsharded_and_reference(runs, world):
    _, ref, ranks = runs
    base = ranks[1][0]["gba_unsharded"]
    d_state, d_cost = _gba_spread(ranks)
    for out in ranks[world]:
        got = out["gba"]
        # the same bits on every rank
        for a, b in zip(got["state"], ranks[world][0]["gba"]["state"]):
            np.testing.assert_array_equal(a, b)
        # test_parallel.py's bounds against the port's unsharded step
        assert _rel(got["cost"], base["cost"]) <= 1e-8
        assert _max_abs(got["state"], base["state"]) <= 1e-9
        assert got["lam"] == base["lam"]
        # the reference's step, within GBA_FACTOR times the one-ulp spread
        assert _max_abs(got["state"], ref["gba"]["state"]) <= GBA_FACTOR * d_state
        assert _rel(got["cost"], ref["gba"]["cost"]) <= GBA_FACTOR * d_cost
        assert got["lam"] == ref["gba"]["lam"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pose_graph_matches_unsharded_and_reference(runs, world):
    inputs, ref, ranks = runs
    _, gt = inputs["pgo"]
    base = ranks[1][0]["pgo_unsharded"]["poses"]
    spread = max(float(np.abs(r["pgo_ulp"]["poses"] - base).max()) for r in ranks[2])
    assert spread > 0
    from covins_tpu_torch.utils import geometry as geo
    for out in ranks[world]:
        got = out["pgo"]["poses"]
        np.testing.assert_array_equal(got, ranks[world][0]["pgo"]["poses"])
        if world == 1:
            np.testing.assert_array_equal(got, base)
            assert out["pgo"]["cost"] == ranks[1][0]["pgo_unsharded"]["cost"]
        assert float(np.abs(got - base).max()) <= GBA_FACTOR * spread
        assert float(np.abs(got - ref["pgo"]).max()) <= GBA_FACTOR * spread
        err = geo.pose_boxminus(torch.from_numpy(got), gt).abs().max()
        assert float(err) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", ["fused", "classic"])
def test_count_collectives_matches_its_formula(runs, world, variant):
    _, _, ranks = runs
    n_cg = COUNT_CG
    want = {"all_reduce": n_cg + (3 if variant == "fused" else 2), "all_reduce_start": 0,
            "all_gather": 0, "reduce_scatter": 0, "collective_permute": 0}
    for out in ranks[world]:
        assert out[f"count_{variant}"] == want


def test_padding_changes_no_result(runs):
    _, _, ranks = runs
    out = ranks[1][0]
    got, want = out["gba_padded"], out["gba"]
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(a[:b.shape[0]], b)
    assert got["state"][3].shape[0] == 98 and not got["state"][3][96:].any()
    assert _rel(got["cost"], want["cost"]) <= 1e-12 and got["lam"] == want["lam"]
    np.testing.assert_array_equal(out["pgo_padded"]["poses"], out["pgo"]["poses"])
    assert _rel(out["pgo_padded"]["cost"], out["pgo"]["cost"]) <= 1e-12


def test_topk_candidates_orders_ties_as_lax_top_k():
    """Tied scores and masked rows (-1) with k above the valid count: the
    port's stable sort and `jax.lax.top_k` give the same indices, the lower
    index first among equal scores."""
    import jax.numpy as jnp

    from covins_tpu.ops import bow as ref_bow

    rng = np.random.default_rng(3)
    s = rng.random(300).astype(np.float32)
    s[[7, 50, 51, 299]] = s.max() + 1.0  # four tied best scores
    s[[20, 21]] = 0.5
    s[rng.random(300) < 0.9] = -1.0  # most rows masked
    s[[7, 50, 51, 299]] = 2.0
    n_valid = int((s > -1).sum())
    for k in (3, n_valid, n_valid + 40):
        got = bow.topk_candidates(torch.from_numpy(s), k)
        want = ref_bow.topk_candidates(jnp.asarray(s), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1][:4].numpy(), [7, 50, 51, 299])


# ----------------------------------------------------------------- slow lane
def _dryrun_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        from covins_tpu_torch.parallel.dryrun import dryrun_multichip
        torch.save(dryrun_multichip(sh.make_mesh(world, device="cpu")),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_dryrun_multichip_world4(tmp_path):
    mp.start_processes(_dryrun_main, args=(4, str(tmp_path / "store"), str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    assert all(o == outs[0] for o in outs) and outs[0]["knn"] == (5, 0)


@pytest.mark.slow
def test_sharded_step_world4_matches_reference_sharded_step(runs):
    """World 4 against the reference's `gba_step_sharded` on its 8-device
    mesh, which runs the step op by op (some four minutes, hence the slow
    lane).  The reference's sharded step and its jitted one sum in other
    orders and end apart by about as much as 10 one-ulp spreads of the
    port's step, so that distance joins the spread's readings."""
    import jax.numpy as jnp

    from covins_tpu.parallel import sharding as ref_sh

    inputs, ref, ranks = runs
    d_state, d_cost = _gba_spread(ranks)
    p = inputs["gba"]
    mesh = ref_sh.make_mesh(8)
    rp = _reference_problem(p)
    p8 = ref_sh.shard_gba_problem(mesh, ref_sh.pad_to_multiple(rp, 8))
    st, lam, cost = ref_sh.gba_step_sharded(mesh, p8, (p8.poses, p8.vels, p8.biases, p8.lms),
                                            jnp.asarray(1e-4), n_cg=N_CG)
    want = [np.asarray(x) for x in st]
    want[3] = want[3][:p.lms.shape[0]]
    d_state = max(d_state, _max_abs(want, ref["gba"]["state"]))
    d_cost = max(d_cost, _rel(float(cost), ref["gba"]["cost"]))
    got = ranks[4][0]["gba"]
    assert _rel(got["cost"], float(cost)) <= GBA_FACTOR * d_cost
    assert _max_abs(got["state"], want) <= GBA_FACTOR * d_state
    assert got["lam"] == float(lam)
