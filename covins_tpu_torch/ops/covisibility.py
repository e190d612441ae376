"""Covisibility-graph and keyframe-redundancy ops over the observation COO.

Counterpart of `covins_tpu/ops/covisibility.py`: the reference's
per-keyframe covisibility bookkeeping
(`KeyframeBase::UpdateCovisibilityConnections`,
`covins_backend/src/covins_backend/keyframe_be.cpp:559-608`: count shared
landmarks per keyframe pair) and the redundancy scoring of keyframe
culling (`Keyframe::ComputeRedundancyValue`, `keyframe_be.cpp:228-256`,
the Schmuck & Chli 3DV'19 scheme), computed in batch from the observation
list (obs_kf, obs_lm) whenever needed.

:func:`redundancy_values` is kernel K15 (`csrc/redundancy_values.cu`) on a
CUDA tensor and :func:`redundancy_values_plain` on a CPU one.  Its float32
sums are taken in observation order, as the JAX package's scatter-add on
the CPU takes them, so that the values, and the keyframe that culling
erases among near-ties, are the same on every device.
:func:`covis_weights_batch` is kernel K17 (`csrc/covis_weights.cu`) on a
CUDA tensor and :func:`covis_weights_batch_plain` on a CPU one: integer
counts, exact in any order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_tensor, is_cpu

# Redundancy score by landmark observation count ({2: 0, 3: 0.4, 4: 0.7,
# 5: 0.9, >=6: 1.0}, `keyframe_be.cpp:228-256`); the kernel holds the same
# float32 values
RED_TABLE = (0.0, 0.0, 0.0, 0.4, 0.7, 0.9, 1.0)

# queries a batch of covis_weights_batch_plain handles at once: bounds its
# (Q, O) intermediate
_QUERY_BATCH = 64

# the most observations K17 takes, and the query bitmap's words a pass
# (kPassWords of csrc/covis_weights.cu: 1,024 queries)
_K17_MAX_OBS = 1 << 29
_K17_PASS_WORDS = 32

# K15's slots for its grid's per-block totals (kMaxGrid of
# csrc/redundancy_values.cu), part of the scratch the wrapper allocates
_K15_GRID_SLOTS = 2048


def k15_scratch_len(O: int, n_kf: int, n_lm: int) -> int:
    """int32 entries of K15's scratch: its (score, mask) pairs, counts,
    segment starts, keyframe lists and partition
    (`csrc/redundancy_values.cu`)."""
    return 4 * O + n_lm + 3 * n_kf + 2 + _K15_GRID_SLOTS


def landmark_obs_counts(obs_lm: torch.Tensor, obs_mask: torch.Tensor,
                        n_lm: int) -> torch.Tensor:
    """(n_lm,) int32 live-observation count of each landmark."""
    return torch.zeros(n_lm, dtype=torch.int32, device=obs_lm.device).index_add_(
        0, obs_lm.long(), obs_mask.to(torch.int32))


def k17_scratch_len(Q: int, n_kf: int, n_lm: int) -> int:
    """int32 entries of K17's scratch: the query bitmap of each landmark and
    its nonzero words, the queries of each keyframe and their nonzero words,
    ws words a row for ws = min(ceil(Q / 32), 32) (`csrc/covis_weights.cu`)."""
    ws = min(-(-Q // 32), _K17_PASS_WORDS)
    return (n_lm + n_kf) * (ws + 1)


def covis_weights_batch_plain(query_kfs: torch.Tensor, obs_kf: torch.Tensor,
                              obs_lm: torch.Tensor, obs_mask: torch.Tensor,
                              n_kf: int, n_lm: int) -> torch.Tensor:
    """Plain version of :func:`covis_weights_batch` on any device."""
    dev = obs_kf.device
    kf, lm = obs_kf.long(), obs_lm.long()
    live = obs_mask.bool()
    queries = query_kfs.long().to(dev)
    out = torch.zeros((len(queries), n_kf), dtype=torch.int32, device=dev)
    for s in range(0, len(queries), _QUERY_BATCH):
        q = queries[s:s + _QUERY_BATCH]
        mine = ((kf[None, :] == q[:, None]) & live[None, :]).to(torch.int32)
        seen = torch.zeros((len(q), n_lm), dtype=torch.int32, device=dev)
        seen.scatter_reduce_(1, lm.expand(len(q), -1), mine, "amax")
        contrib = seen.gather(1, lm.expand(len(q), -1)) * live.to(torch.int32)
        counts = out[s:s + len(q)]
        counts.scatter_add_(1, kf.expand(len(q), -1), contrib)
        counts[torch.arange(len(q), device=dev), q] = 0
    return out


def covis_weights_batch(query_kfs: torch.Tensor, obs_kf: torch.Tensor,
                        obs_lm: torch.Tensor, obs_mask: torch.Tensor,
                        n_kf: int, n_lm: int) -> torch.Tensor:
    """(Q,) query keyframe rows -> (Q, n_kf) int32 covisibility weights: the
    live observations of each keyframe whose landmark the query observes
    live (a landmark the query sees twice counts once, a keyframe that sees
    it twice twice; the query's own entry 0;
    `covins_tpu/ops/covisibility.py:45`).

    query_kfs: (Q,) int32, 0 <= query < n_kf; obs_kf, obs_lm: (O,) int32,
    0 <= obs_kf < n_kf and 0 <= obs_lm < n_lm; obs_mask: (O,) bool.  CPU
    tensors take the plain version; CUDA tensors launch kernel K17 once
    (none for Q = 0 or n_kf = 0), or raise."""
    tensors = (query_kfs, obs_kf, obs_lm, obs_mask)
    if all(is_cpu(t) for t in tensors):
        return covis_weights_batch_plain(*tensors, n_kf, n_lm)
    name = "covis_weights_batch"
    dev = check_cuda(name, *tensors)
    Q = query_kfs.shape[0] if query_kfs.dim() == 1 else -1
    O = obs_kf.shape[0] if obs_kf.dim() == 1 else -1
    q_ptr = check_tensor(name, "query_kfs", query_kfs, (Q,), torch.int32)
    kf_ptr = check_tensor(name, "obs_kf", obs_kf, (O,), torch.int32)
    lm_ptr = check_tensor(name, "obs_lm", obs_lm, (O,), torch.int32)
    m_ptr = check_tensor(name, "obs_mask", obs_mask, (O,), torch.bool)
    if n_kf < 0 or n_lm < 1 or O > _K17_MAX_OBS or n_kf + n_lm >= 1 << 30:
        raise ValueError(f"{name}: needs n_kf >= 0, n_lm >= 1, O <= {_K17_MAX_OBS} and "
                         f"n_kf + n_lm < 2**30; got n_kf={n_kf}, n_lm={n_lm}, O={O}")
    out = torch.empty((Q, n_kf), dtype=torch.int32, device=dev)
    if Q == 0 or n_kf == 0:
        return out
    scratch = torch.empty(k17_scratch_len(Q, n_kf, n_lm), dtype=torch.int32, device=dev)
    lib = cuda_build.library("covis_weights")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_covis_weights(q_ptr, Q, kf_ptr, lm_ptr, m_ptr, O, n_kf, n_lm,
                                      scratch.data_ptr(), scratch.numel(), out.data_ptr(),
                                      stream)
    cuda_build.check(rc, name)
    covis_weights_batch.launches += 1
    return out


covis_weights_batch.launches = 0


def covis_weights_for(query_kf: int, obs_kf: torch.Tensor, obs_lm: torch.Tensor,
                      obs_mask: torch.Tensor, n_kf: int, n_lm: int) -> torch.Tensor:
    """(n_kf,) int32 covisibility weights of one keyframe row, through
    :func:`covis_weights_batch`."""
    q = torch.as_tensor([int(query_kf)], dtype=torch.int32, device=obs_kf.device)
    return covis_weights_batch(q, obs_kf, obs_lm, obs_mask, n_kf, n_lm)[0]


def _scores(obs_lm, obs_mask, n_lm):
    """Each observation's score: the table at its landmark's live count,
    times its mask (float32, as `_RED_TABLE[...] * obs_mask`)."""
    table = torch.tensor(RED_TABLE, dtype=torch.float32, device=obs_lm.device)
    counts = landmark_obs_counts(obs_lm, obs_mask, n_lm)
    return table[counts.clamp(0, 6).long()][obs_lm.long()] * obs_mask


def ordered_segment_sums(seg: torch.Tensor, values: torch.Tensor,
                         n_seg: int) -> torch.Tensor:
    """(n_seg,) float32 sums of ``values`` by segment id, each segment's
    values added one at a time in their order in ``values``, from +0.0 (a
    scatter-add in observation order, as the CPU's is, on any device).
    The values go into a (longest segment, n_seg) table in order, padded
    with zeros, which are added row by row: adding +0.0 leaves a sum that
    starts at +0.0 unchanged."""
    dev = values.device
    tot = torch.zeros(n_seg, dtype=values.dtype, device=dev)
    if values.numel() == 0:
        return tot
    seg = seg.long()
    order = torch.sort(seg, stable=True).indices
    sorted_seg = seg[order]
    sizes = torch.bincount(sorted_seg, minlength=n_seg)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(len(seg), device=dev) - starts[sorted_seg]
    table = torch.zeros((int(sizes.max()), n_seg), dtype=values.dtype, device=dev)
    table[pos, sorted_seg] = values[order]
    for row in table:
        tot = tot + row
    return tot


def redundancy_values_plain(obs_kf: torch.Tensor, obs_lm: torch.Tensor,
                            obs_mask: torch.Tensor, n_kf: int, n_lm: int) -> torch.Tensor:
    """Plain version of :func:`redundancy_values` on any device."""
    per_obs = _scores(obs_lm, obs_mask, n_lm)
    tot = ordered_segment_sums(obs_kf, per_obs, n_kf)
    cnt = ordered_segment_sums(obs_kf, obs_mask, n_kf)
    return tot / torch.maximum(cnt, torch.ones_like(cnt))


def redundancy_values(obs_kf: torch.Tensor, obs_lm: torch.Tensor, obs_mask: torch.Tensor,
                      n_kf: int, n_lm: int) -> torch.Tensor:
    """Per-keyframe redundancy value: the mean, over a keyframe's
    observations weighted by ``obs_mask``, of the score of each landmark's
    live observation count (`covins_tpu/ops/covisibility.py:58`).

    obs_kf, obs_lm: (O,) int32 rows, 0 <= obs_kf < n_kf and 0 <= obs_lm <
    n_lm; obs_mask: (O,) float32 (a landmark's count adds the mask
    truncated to an integer).  Returns (n_kf,) float32, 0 for keyframes
    with no observation.  A CPU tensor takes the plain version; a CUDA
    tensor launches kernel K15 once, or raises."""
    if is_cpu(obs_kf) and is_cpu(obs_lm) and is_cpu(obs_mask):
        return redundancy_values_plain(obs_kf, obs_lm, obs_mask, n_kf, n_lm)
    dev = check_cuda("redundancy_values", obs_kf, obs_lm, obs_mask)
    O = obs_kf.shape[0] if obs_kf.dim() == 1 else -1
    kf = check_tensor("redundancy_values", "obs_kf", obs_kf, (O,), torch.int32)
    lm = check_tensor("redundancy_values", "obs_lm", obs_lm, (O,), torch.int32)
    mask = check_tensor("redundancy_values", "obs_mask", obs_mask, (O,), torch.float32)
    if n_kf < 0 or n_lm < 1:
        raise ValueError(f"redundancy_values: n_kf={n_kf}, n_lm={n_lm}")
    out = torch.empty(n_kf, dtype=torch.float32, device=dev)
    if n_kf == 0:
        return out
    scratch = torch.empty(k15_scratch_len(O, n_kf, n_lm), dtype=torch.int32, device=dev)
    lib = cuda_build.library("redundancy_values")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_redundancy_values(kf, lm, mask, O, n_kf, n_lm, scratch.data_ptr(),
                                          scratch.numel(), out.data_ptr(), stream)
    cuda_build.check(rc, "redundancy_values")
    redundancy_values.launches += 1
    return out


redundancy_values.launches = 0
