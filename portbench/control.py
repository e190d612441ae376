"""Readings for the limits of `correct`: the program's, and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 20 [--out FILE]

For each seed, one run of the cell at its own size and load (the window
shorter than a measured run's), then every number compared twice against
the float64 reference: for the program's answers (the lower readings) and
for the control's, the reference put in the program's place one precision
lower than the configuration states (the database in bfloat16 for its
float32, the geometry in float32 for its float64: the attribute refresh,
stage 4's loop transform and the pose-graph solves).  One JSON line a seed.
The benchmark's own runs never run this.  Needs a CUDA card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, cap, ref, dtype_bow, dtype_geo, device):
    """The program's numbers and the control's, against ``ref``."""
    from portbench.harness import check

    ctrl = check.reference_answers(cell, cap, cap["vocab"], dtype_bow, dtype_geo, device)
    loop_T = {i: r["T_12"] for i, r in enumerate(ctrl["loops"]) if r.get("T_12") is not None}
    pgo_P = {i: r["poses"] for i, r in enumerate(ctrl["pgo"]) if "poses" in r}
    return (check.numbers(cell, cap, check.program_answers(cap), ref),
            check.numbers(cell, cap, ctrl, ref, loop_T=loop_T, pgo_P=pgo_P))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cellrun, check, drive

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = drive.load_cell(args.workload)
    torch.set_num_threads(cell.config["host_threads"])
    inf = {k: float("inf") for k in check.NUMBERS[cell.mode]}
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, prog, cap, ref = cellrun.run(cell, seed, args.seconds, False, "cuda", t0,
                                        limits=inf, warm=i == 0)
        _, ctrl = readings(cell, cap, ref, torch.bfloat16, torch.float32, "cuda")
        line = json.dumps({"cell": cell.name, "seed": seed, "program": prog, "control": ctrl,
                           "loops": sum(1 for r in cap["loops"] if r["out"]["ok"]),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    bad = cellrun.forbidden_modules()
    if bad:
        print(f"control: loaded modules of {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
