#!/usr/bin/env python3
"""Time K15 (keyframe culling's redundancy values) of the PyTorch port on
one CUDA card, at every shape of its card tests.

    python scripts/port_k15_probe.py [--tree DIR]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so that two versions can be
compared in one run on one card, in turns; the shapes and inputs
(``K15_CASES`` and ``_k15_inputs`` of ``tests/test_torch_kernels_cuda.py``)
and the timing (``chip_smoke.py``) come from this checkout either way.
Prints the card's name and power limit, then one JSON line with, for each
shape, the mean time between back-to-back calls (CUDA events, ``ms``), the
card's busy time per call (``chip_smoke.busy_ms``), the busy time of one
``index_add_`` of the observations' scores into the keyframes (the
library yardstick of ``chip_smoke.k15_case``), and whether two launches
equal the plain version on the CPU bit for bit; and the ``-Xptxas -v``
register, shared-memory and spill lines of ``csrc/redundancy_values.cu``.
``prunemap_like`` is prunemap's size (160 keyframes, 27,441 landmarks,
101,712 observations) in a map's order.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("port_k15_probe: no CUDA card", file=sys.stderr)
        return 2
    smoke = _module("smoke", ROOT / "chip_smoke.py")
    cases = _module("k15_cases", ROOT / "tests" / "test_torch_kernels_cuda.py")
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import covisibility as cov

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    cuda_build.build_all(["redundancy_values"])
    # the compiler's report, from a build of its own (the library may be cached)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          *cuda_build.EXTRA_FLAGS.get("redundancy_values", []), "-o",
                          str(cuda_build.BUILD_DIR / "ptxas-redundancy_values.so"),
                          str(cuda_build.CSRC / "redundancy_values.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    dev = torch.device("cuda", 0)
    out = {"tree": args.tree, "card": card,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "smem" in ln]}
    for n_kf, n_lm, O, case in cases.K15_CASES:
        host = [torch.from_numpy(x) for x in cases._k15_inputs(n_kf, n_lm, O, case)]
        kf, lm, mask = (x.to(dev) for x in host)
        want = cov.redundancy_values_plain(*host, n_kf, n_lm).view(torch.int32)

        def kernel():
            return cov.redundancy_values(kf, lm, mask, n_kf, n_lm)

        got, again = kernel(), kernel()
        scores = torch.rand(O, device=dev)
        acc = torch.zeros(n_kf, device=dev)
        kf_long = kf.long()
        reps = 20 if max(O, n_kf) > 150_000 else 50
        out[case] = {
            "shape": [n_kf, n_lm, O],
            "exact": torch.equal(got.cpu().view(torch.int32), want)
                     and torch.equal(again.cpu().view(torch.int32), want),
            "ms": smoke.cuda_ms(kernel, reps), "busy_ms": smoke.busy_ms(kernel, reps),
            "index_add_busy_ms": smoke.busy_ms(lambda: acc.index_add_(0, kf_long, scores),
                                               reps)}
    print(json.dumps(out))
    return 0 if all(v["exact"] for v in out.values() if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
