#!/usr/bin/env python3
"""Time the pose-graph and GBA products and PCG kernels of the PyTorch port
on one CUDA card, at the main path's sizes.

    python scripts/port_pcg_probe.py [--tree DIR]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``), so that two
versions can be compared in one run on one card, in turns.  Prints one
JSON line with, for each kernel entry, the mean time between back-to-back
wrapper calls (CUDA events: what a caller waits) and the card's busy time
per call (torch.profiler: the kernels alone), beside one ``torch.mv`` on
the same matrix assembled densely.  Sizes: bench.py's GBA problem (256
keyframes, 8192 landmarks, max_obs 61440, `utils/synthetic.build_gba_problem`)
with 60 PCG iterations, and a 256-pose graph of 1270 edges
(`utils/synthetic.build_pose_graph`) with 100; each PCG kernel also with 0
iterations, whose time is the launch and the initial product alone.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(fn, reps):
    """The card's kernel time per call, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    return total / 1e6 / reps


def both(fn, reps):
    return {"call_ms": cuda_ms(fn, reps), "busy_ms": busy_ms(fn, reps)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("port_pcg_probe: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import dense_normal_matrix, dense_reduced_matrix
    from covins_tpu_torch.ops import gba, pgo
    from covins_tpu_torch.utils import synthetic

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    out = {"tree": args.tree, "card": card, "module": gba.__file__}

    p, _, _ = synthetic.build_gba_problem(n_kf=256, n_lm=8192, seed=0, max_obs=61440,
                                          device=dev)
    graph = gba.obs_graph(p)
    s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64, device=dev), False)
    n = p.poses.shape[0]
    v6 = torch.randn((n, 6), dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    out["gba_shape"] = [n, p.lms.shape[0], p.obs_kf.shape[0]]
    out["gba_reduced_matvec"] = both(
        lambda: gba.reduced_matvec(v6, None, s.Jp, s.Jl, s.Hll_inv, graph, n), 200)
    out["gba_reduced_matvec_t_only"] = both(
        lambda: gba.reduced_matvec(v6, None, s.Jp, s.Jl, s.Hll_inv, graph, n, True), 200)
    S = dense_reduced_matrix(s.Jp, s.Jl, s.Hll_inv, graph, n)
    vv = v6.reshape(-1)
    out["gba_torch_mv"] = both(lambda: torch.mv(S, vv), 200)
    del S
    for n_cg in (60, 0):
        out[f"gba_pcg_{n_cg}"] = both(lambda: gba.pcg(s, graph, n_cg), 20)

    g, _ = synthetic.build_pose_graph(n_kf=256, seed=0, device=dev)
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    pg = pgo.matvec_graph(g.edge_i, g.edge_j, 256)
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)
    out["pgo_shape"] = [256, Ji.shape[0]]
    out["pgo_matvec"] = both(lambda: pgo.matvec(b, free, Ji, Jj, pg, 1e-6), 200)
    H = dense_normal_matrix(free, Ji, Jj, pg, 1e-6)
    bb = b.reshape(-1)
    out["pgo_torch_mv"] = both(lambda: torch.mv(H, bb), 200)
    for n_it in (100, 0):
        out[f"pgo_pcg_{n_it}"] = both(
            lambda: pgo.pcg(b, Minv, free, Ji, Jj, pg, 1e-6, n_it), 20)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
