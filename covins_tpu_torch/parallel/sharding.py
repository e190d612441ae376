"""Multi-device sharding with ``torch.distributed``.

Counterpart of `covins_tpu/parallel/sharding.py`.  The reference lays
arrays out over a `jax.sharding.Mesh` and lets GSPMD insert the
collectives; here every rank is one process with one device, holds its
own block of the sharded arrays, and the collectives are explicit calls,
each through this module's wrappers, which count them (:data:`counts`):

* **retrieval axis**: the BoW database and the descriptor database are
  split by rows; a query is a local product and top-k, merged by one
  ``all_gather`` of each rank's k (value, global index) pairs
  (:func:`sharded_topk_scores`, :func:`sharded_hamming_knn`);
* **solver axis**: a GBA problem is split by landmarks, each rank holding
  its landmark block with every observation of those landmarks, so the
  landmark elimination is local and only per-keyframe sums cross ranks
  (:func:`shard_gba_problem`, :func:`gba_step_sharded`); a pose graph is
  split by edges, each node's sums added over ranks
  (:func:`shard_pose_graph`, :func:`optimize_pose_graph_sharded`).

On a card the group runs NCCL, rank r on ``cuda:r``; only with
``device="cpu"`` does it run gloo.  Nothing falls back: a failed
initialisation, build or launch raises.  The device work of every path is
the port's hand-written kernels: K11's top-2 entry or K1 for the Hamming
k-NN, K8 and K9 for the GBA step, K7 for the pose graph; the retrieval's
float32 matvec is a library product, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from covins_tpu_torch.device import DeviceLike, resolve_device
from covins_tpu_torch.ops import bow
from covins_tpu_torch.ops import descriptors as d_ops
from covins_tpu_torch.ops import gba as gba_mod
from covins_tpu_torch.ops import pgo as pgo_mod
from covins_tpu_torch.utils import geometry as geo

# the collectives the reference's count_collectives reports, counted by the
# wrappers below (plus the broadcasts of :func:`replicate`)
COLLECTIVES = ("all_reduce", "all_reduce_start", "all_gather", "reduce_scatter",
               "collective_permute")
counts = dict.fromkeys(COLLECTIVES + ("broadcast",), 0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis device mesh: its process group, the
    world size, its rank, its device and the group's backend."""

    group: object
    world: int
    rank: int
    device: torch.device
    backend: str
    axis: str = "data"

    def all_reduce(self, *tensors):
        """Sum each tensor over the ranks with one collective (the tensors,
        of one dtype, packed into one buffer); returns the sums."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        counts["all_reduce"] += 1
        return tuple(x.view(t.shape) for x, t in
                     zip(torch.split(flat, [t.numel() for t in tensors]), tensors))

    def all_gather(self, x):
        """Every rank's ``x`` stacked in rank order (world, *x.shape), one
        collective."""
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        counts["all_gather"] += 1
        return torch.stack(out)


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank % torch.cuda.device_count()) if dev.type == "cuda" else dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: DeviceLike = None) -> Mesh:
    """This rank's :class:`Mesh`.  With no process group yet and one device
    asked for (``n_devices`` None or 1), start a group of one (a
    ``HashStore``); a larger mesh needs ``torch.distributed.
    init_process_group`` (or :func:`multihost_initialize`) first, and
    ``n_devices`` must equal its world size.  ``device``: the card by
    default (NCCL, rank r on ``cuda:r``), ``"cpu"`` for gloo."""
    dev = resolve_device(device)
    backend = _backend(dev)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh({n_devices}): initialise the process group first "
                               "(torch.distributed.init_process_group or multihost_initialize)")
        kw = {"device_id": _rank_device(dev, 0)} if dev.type == "cuda" else {}
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the group has {world}")
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"make_mesh: the process group runs {got}; {dev} needs {backend}")
    return Mesh(dist.group.WORLD, world, rank, _rank_device(dev, rank), backend, axis)


def multihost_initialize(coordinator: str, num_processes: int, process_id: int,
                         device: DeviceLike = None):
    """Join a group of ``num_processes`` over TCP (``coordinator`` is
    "host:port"); call once per process before :func:`make_mesh`.
    ``device`` as in :func:`make_mesh`."""
    dev = resolve_device(device)
    kw = {"device_id": _rank_device(dev, process_id)} if dev.type == "cuda" else {}
    dist.init_process_group(_backend(dev), init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)


def shard_rows(mesh: Mesh, x):
    """This rank's contiguous block of ``x``'s leading axis, on the mesh's
    device.  Raises unless the axis divides by the world size."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"shard_rows: {n} rows do not divide over {mesh.world} devices")
    blk = n // mesh.world
    return x[mesh.rank * blk:(mesh.rank + 1) * blk].to(mesh.device).contiguous()


def replicate(mesh: Mesh, x):
    """``x`` on the mesh's device with rank 0's bits on every rank (one
    broadcast)."""
    t = torch.as_tensor(x).to(mesh.device).clone().contiguous()
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=0,
                   group=mesh.group)
    counts["broadcast"] += 1
    return t


# ---------------------------------------------------------------------------
# Row-sharded retrieval: a local product and top-k, merged by one all_gather
# ---------------------------------------------------------------------------


def _ordered(key, idx, descending: bool):
    """Sort pairs along the last axis by ``key``, the lower ``idx`` first
    among equal keys (``jax.lax.top_k``'s order); returns (key, idx)."""
    o = torch.sort(idx, dim=-1, stable=True).indices
    key, idx = key.gather(-1, o), idx.gather(-1, o)
    o = torch.sort(key, dim=-1, descending=descending, stable=True).indices
    return key.gather(-1, o), idx.gather(-1, o)


def sharded_topk_scores(mesh: Mesh, db_rows, query, mask_rows, k: int = 10):
    """Cosine retrieval over a row-sharded database (B15): each rank scores
    its rows ``db_rows`` (N / world, V) against ``query`` (V,) with one
    ``torch.mv``, masked rows at -1, takes its top k, and one
    ``all_gather`` of the world x k (score, global index) pairs gives the
    global top k.  Returns (scores_k (k,), idx_k (k,) int64), descending,
    ties to the lower index, as ``jax.lax.top_k``."""
    n_local = db_rows.shape[0]
    if not 1 <= k <= n_local * mesh.world:
        raise ValueError(f"sharded_topk_scores: k={k} outside [1, {n_local * mesh.world}]")
    scores = bow.retrieval_scores(query, db_rows, mask_rows)
    vals, idx = bow.topk_candidates(scores, min(k, n_local))
    # float32 scores and indices below 2^53 are exact in float64: one gather
    pairs = torch.stack([vals.double(), (idx + mesh.rank * n_local).double()])
    pairs = mesh.all_gather(pairs)
    vals, idx = _ordered(pairs[:, 0].reshape(-1).to(scores.dtype),
                         pairs[:, 1].reshape(-1).long(), descending=True)
    return vals[:k], idx[:k]


def sharded_hamming_knn(mesh: Mesh, db_rows_pm1, query_pm1, k: int = 2):
    """Exact Hamming k-NN against a row-sharded database (B14):
    ``db_rows_pm1`` (N / world, D) and ``query_pm1`` (Q, D) in {-1, +1},
    packed to the port's LSB-first bytes (:func:`descriptors.pack_pm1`);
    each rank's top k by :func:`descriptors.hamming_knn` (k <= 2: K11's
    top-2 entry; larger k: K1's distances and a stable sort), merged by one
    ``all_gather`` of (distance, global index).  Returns (dist_k (Q, k)
    int32, idx_k (Q, k) int64), nearest first, ties to the lower index.
    On a card the kernels take 256-bit descriptors only."""
    nbits = db_rows_pm1.shape[-1]
    if mesh.device.type == "cuda" and nbits != 8 * d_ops.ORB_BYTES:
        raise ValueError(f"sharded_hamming_knn: on the card the kernels take "
                         f"{8 * d_ops.ORB_BYTES}-bit descriptors, got {nbits}")
    db_u8, q_u8 = d_ops.pack_pm1(db_rows_pm1), d_ops.pack_pm1(query_pm1)
    n_local, n_q = db_u8.shape[0], q_u8.shape[0]
    if not 1 <= k <= n_local * mesh.world:
        raise ValueError(f"sharded_hamming_knn: k={k} outside [1, {n_local * mesh.world}]")
    dist_k, idx = d_ops.hamming_knn(q_u8, db_u8, min(k, n_local))
    pairs = mesh.all_gather(torch.stack([dist_k.long(), idx.long() + mesh.rank * n_local]))
    pairs = pairs.permute(1, 2, 0, 3).reshape(2, n_q, -1)
    dist_k, idx = _ordered(pairs[0], pairs[1], descending=False)
    return dist_k[:, :k].to(torch.int32), idx[:, :k]


# ---------------------------------------------------------------------------
# Landmark-sharded GBA: the Schur step with per-keyframe sums all-reduced
# ---------------------------------------------------------------------------


def pad_to_multiple(p: gba_mod.GBAProblem, multiple: int) -> gba_mod.GBAProblem:
    """Pad a GBA problem's observation and landmark axes with masked slots
    (observations of keyframe 0 and landmark 0, zero weight) to multiples
    of ``multiple``."""

    def pad1(x, n_pad, fill=0):
        if n_pad == 0:
            return x
        return torch.cat([x, torch.full((n_pad,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=x.device)])

    o_pad = (-p.obs_kf.shape[0]) % multiple
    m_pad = (-p.lms.shape[0]) % multiple
    return dataclasses.replace(
        p, obs_kf=pad1(p.obs_kf, o_pad), obs_lm=pad1(p.obs_lm, o_pad),
        obs_uv=pad1(p.obs_uv, o_pad), obs_w=pad1(p.obs_w, o_pad),
        obs_mask=pad1(p.obs_mask, o_pad, False),
        lms=pad1(p.lms, m_pad), lm_mask=pad1(p.lm_mask, m_pad, False))


@dataclasses.dataclass(frozen=True)
class GBAShard:
    """One rank's part of a GBA problem: every keyframe, IMU and loop
    factor, landmarks [lm_start, lm_start + M / world) and every
    observation of them in the problem's order (``obs_index``), with
    landmark indices local to the block; its observation graph and K8
    inputs, built once."""

    p: gba_mod.GBAProblem
    graph: gba_mod.ObsGraph
    inputs: gba_mod.ReprojInputs
    lm_start: int
    n_lm: int
    obs_index: torch.Tensor

    def state(self):
        """(poses, vels, biases, this rank's landmarks)."""
        return (self.p.poses, self.p.vels, self.p.biases, self.p.lms)


def shard_gba_problem(mesh: Mesh, p: gba_mod.GBAProblem) -> GBAShard:
    """This rank's :class:`GBAShard` of ``p`` (every rank is handed the
    same problem), on the mesh's device.  The landmark count must divide
    by the world size (:func:`pad_to_multiple`).  Unlike the reference,
    which splits observation rows and landmark rows apart and lets GSPMD
    move data between them, the observations follow their landmark, so no
    landmark datum crosses ranks; at world 1 the shard is the whole problem
    in its own order."""
    m = p.lms.shape[0]
    if m % mesh.world:
        raise ValueError(f"shard_gba_problem: {m} landmarks do not divide over "
                         f"{mesh.world} devices (pad_to_multiple)")
    blk = m // mesh.world
    lo = mesh.rank * blk
    obs = torch.nonzero((p.obs_lm >= lo) & (p.obs_lm < lo + blk)).reshape(-1)
    local = dataclasses.replace(
        p, lms=p.lms[lo:lo + blk], lm_mask=p.lm_mask[lo:lo + blk], obs_kf=p.obs_kf[obs],
        obs_lm=p.obs_lm[obs] - lo, obs_uv=p.obs_uv[obs], obs_w=p.obs_w[obs],
        obs_mask=p.obs_mask[obs])
    local = gba_mod.problem_to(local, mesh.device)
    return GBAShard(local, gba_mod.obs_graph(local), gba_mod.reproj_inputs(local), lo, m,
                    obs.to(mesh.device))


def gba_step_sharded(mesh: Mesh, shard: GBAShard, state, lam, n_cg: int = 30,
                     visual_only: bool = False, cg_variant: str = "fused"):
    """One LM/Schur GBA step on a landmark-sharded problem: ``state`` =
    (poses, vels, biases, this rank's landmarks), ``lam`` a device scalar;
    returns (state, lam, cost) with the landmarks this rank's block.  Each
    rank linearises its observations (K8); one ``all_reduce`` sums the
    observation parts of the reduced system, each PCG matvec is the local
    K9 and one ``all_reduce``, and the ladder's reprojection costs one more
    (`ops.gba._gn_schur_step`'s ``allreduce``).  The PCG is the eager loop
    at any world size, since a collective cannot run inside the persistent
    PCG kernel."""
    return gba_mod._gn_schur_step(shard.p, shard.graph, state, lam, n_cg, visual_only,
                                  cg_variant=cg_variant, inputs=shard.inputs,
                                  allreduce=mesh.all_reduce)


def gather_landmarks(mesh: Mesh, shard: GBAShard, lms):
    """Every rank's landmark block in order: the whole (M, 3) landmarks
    (one ``all_gather``)."""
    return mesh.all_gather(lms).reshape(shard.n_lm, 3)


def count_collectives(mesh: Mesh, shard: GBAShard, state, lam, n_cg: int = 30,
                      cg_variant: str = "fused") -> dict:
    """Run one sharded GBA step and count its collectives, under the
    reference's keys (there is no HLO to count: the module's wrappers
    count the calls).  A step issues n_cg + 3 ``all_reduce``s with the
    fused PCG (the reduced system, n_cg + 1 matvecs, the ladder's costs)
    and n_cg + 2 with the classic one (n_cg matvecs), and nothing else."""
    for k in counts:
        counts[k] = 0
    gba_step_sharded(mesh, shard, state, lam, n_cg, False, cg_variant)
    return {k: counts[k] for k in COLLECTIVES}


# ---------------------------------------------------------------------------
# Edge-sharded pose graph
# ---------------------------------------------------------------------------


def shard_pose_graph(mesh: Mesh, g: pgo_mod.PoseGraph,
                     multiple: Optional[int] = None) -> pgo_mod.PoseGraph:
    """This rank's part of a pose graph (every rank is handed the same
    graph): the edges padded to a multiple of ``multiple`` (default the
    world size) with identity measurements, zero sqrt-information and
    mask False, then this rank's contiguous edge block; poses, pose mask
    and fixed flags whole.  On the mesh's device."""
    mult = multiple or mesh.world
    if mult % mesh.world:
        raise ValueError(f"shard_pose_graph: a multiple of {mult} does not divide over "
                         f"{mesh.world} devices")
    pad = (-g.edge_i.shape[0]) % mult
    if pad:
        z = dict(device=g.edge_i.device)
        ident = torch.zeros((pad, 7), dtype=g.edge_T.dtype, **z)
        ident[:, 0] = 1.0
        g = dataclasses.replace(
            g, edge_i=torch.cat([g.edge_i, torch.zeros(pad, dtype=g.edge_i.dtype, **z)]),
            edge_j=torch.cat([g.edge_j, torch.zeros(pad, dtype=g.edge_j.dtype, **z)]),
            edge_T=torch.cat([g.edge_T, ident]),
            edge_sqrt_info=torch.cat([g.edge_sqrt_info, torch.zeros(
                (pad, 6, 6), dtype=g.edge_sqrt_info.dtype, **z)]),
            edge_mask=torch.cat([g.edge_mask, torch.zeros(pad, dtype=torch.bool, **z)]),
            edge_is_loop=torch.cat([g.edge_is_loop, torch.zeros(pad, dtype=torch.bool, **z)]))
    blk = g.edge_i.shape[0] // mesh.world
    lo = mesh.rank * blk
    return pgo_mod.PoseGraph(**{
        f.name: (getattr(g, f.name)[lo:lo + blk] if f.name.startswith("edge_")
                 else getattr(g, f.name)).to(mesh.device).contiguous()
        for f in dataclasses.fields(pgo_mod.PoseGraph)})


def optimize_pose_graph_sharded(mesh: Mesh, g_shard: pgo_mod.PoseGraph, n_gn: int = 8,
                                n_cg: int = 100, damping: float = 1e-6,
                                cauchy_scale: float = 0.0):
    """`ops.pgo.optimize_pose_graph` on an edge-sharded graph
    (:func:`shard_pose_graph`): each rank linearises its edges; one
    ``all_reduce`` sums the gradient and the undamped blocks, to which
    the damping is added once before they are inverted; each PCG matvec is
    the local K7 and one ``all_reduce``, rank 0's K7 alone adding the
    damping (the others pass 0), so it is added once and a group of one
    runs the undivided solve's arithmetic; one ``all_reduce`` sums the two
    costs of the accept test.  Returns (poses (N, 7), final_cost ()), the
    same on every rank."""
    g = g_shard
    n = g.poses.shape[0]
    free = (~g.fixed & g.pose_mask).to(g.poses.dtype)
    graph = pgo_mod.matvec_graph(g.edge_i, g.edge_j, n)
    local_damping = damping if mesh.rank == 0 else 0.0
    poses, cost = g.poses, None
    for _ in range(n_gn):
        r, w, Ji_w, Jj_w, b, M = pgo_mod.edge_sums(poses, g, free, cauchy_scale, graph)
        b, M = mesh.all_reduce(b, M)
        Minv = pgo_mod.inverse_blocks(M, damping)

        def hv(v):
            return mesh.all_reduce(pgo_mod.matvec(v, free, Ji_w, Jj_w, graph,
                                                  local_damping))[0]

        dx = pgo_mod._pcg(hv, b, Minv, free, n_cg) * free[:, None]
        poses_new = geo.pose_boxplus(poses, dx)
        r_new = pgo_mod._edge_residual(poses_new, g)
        c, = mesh.all_reduce(torch.stack([torch.sum(w * torch.sum(r * r, -1)),
                                          torch.sum(w * torch.sum(r_new * r_new, -1))]))
        c_old, c_new = c[0], c[1]
        poses = torch.where(c_new < c_old, poses_new, poses)
        cost = torch.minimum(c_new, c_old)
    return poses, cost


# ---------------------------------------------------------------------------
# Multi-process placement.  In torch every process holds the full host
# array, built deterministically, and takes its own part, so these are the
# functions above under the reference's names.
# ---------------------------------------------------------------------------


def shard_rows_global(mesh: Mesh, x):
    """:func:`shard_rows`: every process holds the whole ``x`` and keeps its
    block."""
    return shard_rows(mesh, x)


def replicate_global(mesh: Mesh, x):
    """:func:`replicate`."""
    return replicate(mesh, x)


def shard_gba_problem_global(mesh: Mesh, p: gba_mod.GBAProblem):
    """:func:`shard_gba_problem`: every process holds the whole problem and
    keeps its landmark block."""
    return shard_gba_problem(mesh, p)
