#!/usr/bin/env python3
"""Where K15's time goes on one CUDA card: the busy time of
``csrc/redundancy_values.cu`` cut short after each of its grid barriers.

    python scripts/port_k15_phases.py

Builds four copies of the kernel's source into ``build/kernels/phases/``:
one that returns right after the barrier that ends phase 0 (the launch and
the counters zeroed), one after phase 1 (the counts and slots), one after
phase 2 (the segment starts and the placement), and the whole kernel.
Each copy is called through the wrapper's C interface on the inputs of
every K15 card-test shape (``tests/test_torch_kernels_cuda.py``) and timed
with ``chip_smoke.busy_ms``; the whole kernel's output is also held
against the plain version bit for bit.  Prints the card's name and power
limit, then one JSON line per shape with each copy's busy microseconds.
A phase's cost is the difference between neighbouring copies.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the text after which each cut copy returns: the end of phases 0, 1 and 2
CUTS = {"phase0": "  grid.sync();\n\n  // 1. counts",
        "phase1": "  grid.sync();\n\n  // 2. segment starts",
        "phase2": "  grid.sync();\n\n  // 3a."}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cuda_build):
    src = (cuda_build.CSRC / "redundancy_values.cu").read_text()
    out = cuda_build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in (*CUTS, "whole"):
        text = src
        if name in CUTS:
            assert CUTS[name] in text, name
            cut = CUTS[name].replace("grid.sync();", "grid.sync();\n  if (p.O >= 0) return;", 1)
            text = text.replace(CUTS[name], cut, 1)
        cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
               "-o", str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    fns = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).covins_redundancy_values
        fn.argtypes = cuda_build.SIGNATURES["redundancy_values"]["covins_redundancy_values"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_k15_phases: no CUDA card", file=sys.stderr)
        return 2
    smoke = _module("smoke", ROOT / "chip_smoke.py")
    cases = _module("k15_cases", ROOT / "tests" / "test_torch_kernels_cuda.py")
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import covisibility as cov

    print(smoke.card_line())
    fns = build(cuda_build)
    dev = torch.device("cuda", 0)
    exact = True
    for n_kf, n_lm, O, case in cases.K15_CASES:
        host = [torch.from_numpy(x) for x in cases._k15_inputs(n_kf, n_lm, O, case)]
        kf, lm, mask = (x.to(dev) for x in host)
        out = torch.empty(n_kf, dtype=torch.float32, device=dev)
        scratch = torch.empty(cov.k15_scratch_len(O, n_kf, n_lm), dtype=torch.int32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {"case": case, "shape": [n_kf, n_lm, O]}
        for name, fn in fns.items():
            def call(fn=fn):
                cuda_build.check(fn(kf.data_ptr(), lm.data_ptr(), mask.data_ptr(), O, n_kf,
                                    n_lm, scratch.data_ptr(), scratch.numel(),
                                    out.data_ptr(), stream), "redundancy_values")

            row[f"{name}_us"] = smoke.busy_ms(call, 20 if max(O, n_kf) > 150_000 else 100) * 1e3
        want = cov.redundancy_values_plain(*host, n_kf, n_lm)
        row["exact"] = torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
        exact &= row["exact"]
        print(json.dumps(row), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
