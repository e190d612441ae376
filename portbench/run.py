"""The benchmark of covins_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card.  It builds
the program's kernels (cached under build/kernels), makes the cell's
streams and vocabulary from the seed, warms the cell's paths on a scratch
manager, drives the closed loop for ``--seconds``, then compares what the
window produced with the plain reference.  The last line of standard
output is the result (JSON); the last lines of standard error are the
numbers compared, each beside its limit.  It exits nonzero, printing no
result, without a card, when a module of JAX or of the JAX package is
loaded, or when the program is missing.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PB = Path(__file__).resolve().parent
ROOT = PB.parent


def _environment(cell: str):
    """Caches at fixed paths inside the checkout, and the configuration's
    host thread count, before numpy and torch load."""
    cache = PB / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    wl = json.loads((PB / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((PB / "configs" / f"{wl['config']}.json").read_text())
    threads = str(cfg["host_threads"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = threads
    return int(threads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    threads = _environment(args.workload)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import cellrun, drive

    cell = drive.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in cellrun.manifest()["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    torch.set_num_threads(threads)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = torch.cuda.get_device_name(0)
    print(json.dumps({"card": card, "cell": cell.name, "seed": args.seed,
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          file=sys.stderr)
    result, _, _, _ = cellrun.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_PROCESS)
    bad = cellrun.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
