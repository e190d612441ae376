#!/usr/bin/env python3
"""How far the PCG loops' results move under rounding differences, on the
CPU (plain versions): the yardstick the card's PCG kernels are held to.

    python scripts/port_pcg_spread.py [--drain]

For each system it prints the readings the card's PCG kernels are held
to (`chip_smoke.rounding_readings`): the plain loop's change when one ulp
is added to every entry of b, when one ulp is taken off, and when the same
loop sums its two dot products per iteration in another order (one
float64 running sum in reverse element order instead of `torch.sum`'s),
which is the kind of rounding difference a kernel with its own reduction
order brings, after 10, 30, 60 and the full iteration count.  Systems: the
synthetic 256-pose graph of `utils/synthetic.build_pose_graph` (100
iterations), with its default weights and with all weights 100 instead;
bench.py's GBA problem (256 keyframes, 8192 landmarks,
max_obs 61440) at its start (60 iterations); with ``--drain``, the largest
pose graph the bench workload's drain solves (2 agents x 128 keyframes,
run on the CPU first, about two minutes).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def spreads(run, b, iters):
    """{iterations: the readings of ``run(b, n, total)`` and the reordered
    sums' change over the larger one-ulp change}."""
    import chip_smoke

    out = {}
    for n in iters:
        _, r = chip_smoke.rounding_readings(lambda bb, total: run(bb, n, total), b)
        ulp = max(r["one_ulp_up"], r["one_ulp_down"])
        out[n] = {**r, "ratio": r["reordered_sums"] / ulp if ulp else float("inf")}
    return out


def pgo_system(g):
    from covins_tpu_torch.ops import pgo

    n = g.poses.shape[0]
    free = (~g.fixed & g.pose_mask).to(torch.float64)
    graph = pgo.matvec_graph(g.edge_i, g.edge_j, n)
    _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)
    return b, Minv, free, Ji, Jj, graph


def pgo_run(b, Minv, free, Ji, Jj, graph, damping=1e-6):
    from covins_tpu_torch.ops import pgo

    def run(bb, n, total):
        return pgo._pcg(lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, damping), bb,
                        Minv, free, n, total)
    return run


def gba_run(s, graph):
    from covins_tpu_torch.ops import gba

    def run(b, n, total):
        return gba.pcg_plain(dataclasses.replace(s, b_red=b), graph, n,
                             gba.reduced_matvec_plain, total)
    return run


def drain_pose_graph():
    """The largest pose-graph solve input of the bench workload's drain
    (CPU, plain versions)."""
    import chip_smoke
    from covins_tpu_torch.ops import bow, pgo

    world, streams = chip_smoke.build_streams(2, 128, 2000)
    windows = chip_smoke.make_windows(streams)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs), k=512, iters=4,
                                 generator=torch.Generator().manual_seed(0)).numpy()
    rec = chip_smoke.Recorder([(pgo, "pcg", lambda b, M, f, Ji, *a: Ji.shape[0])])
    with rec:
        chip_smoke.run_slice(vocab, windows, 2, "cpu")
    return rec.on("pcg", torch.device("cpu"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--drain", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    from covins_tpu_torch.ops import gba, pgo
    from covins_tpu_torch.utils import synthetic

    out = {}
    g, _ = synthetic.build_pose_graph(n_kf=256, seed=0, device="cpu")
    uniform = dataclasses.replace(g, edge_sqrt_info=pgo.make_sqrt_info(
        100.0, 100.0, g.edge_i.shape[0]).contiguous())
    for name, graph in (("pgo_synthetic_256", g), ("pgo_synthetic_256_weights_100", uniform)):
        system = pgo_system(graph)
        out[name] = spreads(pgo_run(*system), system[0], (10, 30, 60, 100))
    if args.drain:
        b, Minv, free, Ji, Jj, graph, damping, n_iters = drain_pose_graph()
        out["pgo_drain"] = spreads(pgo_run(b, Minv, free, Ji, Jj, graph, damping), b,
                                   (10, 30, 60, n_iters))
    p, _, _ = synthetic.build_gba_problem(n_kf=256, n_lm=8192, seed=0, max_obs=61440,
                                          device="cpu")
    graph = gba.obs_graph(p)
    s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                           torch.tensor(1e-4, dtype=torch.float64), False)
    out["gba_bench"] = spreads(gba_run(s, graph), s.b_red, (10, 30, 60))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
