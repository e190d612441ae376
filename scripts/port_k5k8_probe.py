#!/usr/bin/env python3
"""Time project-and-match (K5) and the GBA reprojection factors (K8) of the
PyTorch port on one CUDA card, at the main path's sizes.

    python scripts/port_k5k8_probe.py [--tree DIR]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for
example a parent commit unpacked with ``git archive``), so that two
versions can be compared in one run on one card, in turns; the inputs and
the timing come from this checkout's ``chip_smoke.py`` and
``covins_tpu_torch/utils/synthetic.py`` either way.  Prints
the card's name and power limit, then one JSON line with:

* K5: ``project_match_core`` at verification stage 3's 1024 x 1024 (no
  view-angle gate) and stage 5's largest neighbourhood, 10,070 x 1,024
  (with it), on a random scene (``synthetic.project_match_scene``): the mean time
  between back-to-back calls (CUDA events, what a caller waits), the
  card's busy time per call (the calls queued behind a spin kernel,
  ``chip_smoke.busy_ms``), its kernel launches and the PyTorch operations
  one call issues;
* K8 at bench.py's GBA problem (256 keyframes, 8192 landmarks, max_obs
  61440, ``chip_smoke.gba_kernel_inputs``): a linearisation; the
  reprojection cost of one state and of the step ladder's seven (six
  scales and the current state: one stacked launch where a tree has the
  stacked form, seven where it has not); one whole cost evaluation
  (``total_cost``) and the ladder's seven; each with call and busy time
  (None where one call issues more operations than the card's queue
  holds), K8 launches and PyTorch operations; the outlier norm; and one
  Gauss-Newton step (60 PCG iterations) with its K8 launches;
* the ``-Xptxas -v`` register and spill lines of both sources.
"""

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k5k8_probe: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spec = importlib.util.spec_from_file_location(
        "synthetic_here", ROOT / "covins_tpu_torch" / "utils" / "synthetic.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import gba, projmatch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    logs = cuda_build.build_all(["project_match", "gba_reproj_blocks"])
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    dev = torch.device("cuda", 0)
    # the counter a tree's K5 launches count on: the fused wrapper, or the
    # argmin kernel behind the PyTorch prologue
    counter = getattr(projmatch, "gated_match", projmatch.project_match_core)

    def timed(fn, counted, reps, name):
        before = counted.launches
        fn()
        torch.cuda.synchronize()
        launches = counted.launches - before
        row = {"call_ms": smoke.cuda_ms(fn, reps), "busy_ms": smoke.busy_ms(fn, reps),
               "launches": launches, "ops_per_call": smoke.count_ops(fn)}
        print(json.dumps({name: row}), flush=True)
        return row

    out = {"tree": args.tree, "card": card, "ptxas": ptxas}
    rng = smoke.np.random.default_rng(smoke.SEED)
    for stage, L, view in ((3, 1024, False), (5, 10070, True)):
        a, kw = scenes.project_match_scene(rng, L, 1024, dev, view_angle=view)
        fn = lambda: projmatch.project_match_core(*a, **kw)  # noqa: E731
        out[f"k5_stage{stage}"] = {**timed(fn, counter, 50, f"k5_stage{stage}"),
                                   "shape": [L, 1024]}

    p, graph, _, _ = smoke.gba_kernel_inputs(256, 8192, 61440, dev)
    state = (p.poses, p.vels, p.biases, p.lms)
    ladder = scenes.stacked_states(p, 7)
    singles = [tuple(x[k] for x in ladder) for k in range(7)]
    stacked = hasattr(gba, "reproj_inputs")
    k8 = gba.reproj_blocks
    # a tree whose K8 takes the problem's inputs as an argument gets them
    # built once, as a GBA round gives them
    takes = "inputs" in inspect.signature(k8).parameters
    kw = {"inputs": gba.reproj_inputs(p)} if takes else {}
    out["k8_linearize"] = timed(lambda: k8(p, graph, 0.0, "linearize", **kw), k8, 20,
                                "k8_linearize")
    # K8's cost mode alone: the reprojection sum of one state, and of the
    # ladder's seven (one stacked launch, or seven)
    if stacked:
        one = gba._with_state(p, tuple(x[None] for x in state))
        cost1 = lambda: k8(one, graph, 0.0, "cost", **kw)  # noqa: E731
        cost7 = lambda: k8(gba._with_state(p, ladder), graph, 0.0, "cost", **kw)  # noqa: E731
        ladder_fn = lambda: gba.total_cost(p, graph, ladder, False, **kw)  # noqa: E731
    else:
        cost1 = lambda: torch.sum(k8(p, graph, 0.0, "cost")[0])  # noqa: E731
        cost7 = lambda: [torch.sum(k8(gba._with_state(p, st), graph, 0.0, "cost")[0])  # noqa: E731
                         for st in singles]
        ladder_fn = lambda: [gba.total_cost(p, graph, st, False) for st in singles]  # noqa: E731
    out["k8_cost_s1"] = timed(cost1, k8, 20, "k8_cost_s1")
    out["k8_cost_s7"] = timed(cost7, k8, 20, "k8_cost_s7")
    out["k8_outlier"] = timed(lambda: k8(p, graph, 0.0, "outlier", **kw), k8, 20,
                              "k8_outlier")
    # whole cost evaluations (K8 and the loop and IMU residuals)
    out["cost_eval"] = timed(lambda: gba.total_cost(p, graph, state, False, **kw), k8, 10,
                             "cost_eval")
    out["ladder_costs"] = {**timed(ladder_fn, k8, 5, "ladder_costs"), "stacked": stacked}
    lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    before = k8.launches
    gba._gn_schur_step(p, graph, state, lam, 60, False, **kw)
    out["gn_step"] = {"call_ms": smoke.cuda_ms(
        lambda: gba._gn_schur_step(p, graph, state, lam, 60, False, **kw), 5),
        "k8_launches": k8.launches - before}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
