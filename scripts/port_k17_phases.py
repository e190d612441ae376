#!/usr/bin/env python3
"""Where K17's time goes on one CUDA card: the busy time of
``csrc/covis_weights.cu`` cut short after each of its grid barriers, and
of variants of its launch.

    python scripts/port_k17_phases.py

Builds copies of the kernel's source into ``build/kernels/phases17/``: one
that returns right after the barrier that ends phase 0 (the launch, the
output and the bitmap zeroed, the keyframes' table written), one after
the barrier that ends phase 1 (the mark), the whole kernel; and whole
kernels with the grid on half the co-resident blocks (``grid_half``), with
every warp adding bit by bit (``no_transpose``: no warp sums its lanes by
the transposed bit matrix), with no block gathering counts in shared
memory (``no_window``: every count added into the output in device
memory), held to 32 registers a thread for 8 blocks an SM
(``occupancy8``), loading 8 bitmap words at once (``batch8``), gathering 8
keyframes' counts in shared memory (``window8``), summing warps of at most
2 or 8 keyframes by transposes (``groups2``, ``groups8``), and in blocks
of 128 or 512 threads (``threads128``, ``threads512``).  Each copy is called through the wrapper's C
interface on the inputs of every shape of ``chip_smoke.K17_SMOKE_CASES``
(``chip_smoke.k17_inputs``, a seed) and timed with ``chip_smoke.busy_ms``;
each whole copy's output is also held against the plain version bit for
bit.  Prints the card's name and power limit, then one JSON line per shape
with each copy's busy microseconds.  A phase's cost is the difference
between neighbouring copies.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the text after which each cut copy returns: the ends of phases 0 and 1
CUTS = {"phase0": "    grid.sync();\n\n    // 1. mark",
        "phase1": "    grid.sync();\n\n    // 2. count"}
# whole copies with one text replaced
HALF_GRID = """  int resident = 0;
  coop::co_resident(reinterpret_cast<const void*>(covis_weights_kernel), kThreads, 0, &resident);
  return coop::launch(covis_weights_kernel, kThreads, 0, std::min(items, 128LL * resident),"""
VARIANTS = {"grid_half": ("  return coop::launch(covis_weights_kernel, kThreads, 0, items,",
                          HALF_GRID),
            "no_transpose": ("kMaxGroups = 4;", "kMaxGroups = 0;"),
            "no_window": ("if (k - base >= 0 && k - base < kWindow)", "if (false)"),
            "occupancy8": ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)"),
            "batch8": ("kBatch = 4;", "kBatch = 8;"),
            "window8": ("kWindow = 4;", "kWindow = 8;"),
            "groups2": ("kMaxGroups = 4;", "kMaxGroups = 2;"),
            "groups8": ("kMaxGroups = 4;", "kMaxGroups = 8;"),
            "threads128": ("kThreads = 256;", "kThreads = 128;"),
            "threads512": ("kThreads = 256;", "kThreads = 512;")}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cuda_build):
    src = (cuda_build.CSRC / "covis_weights.cu").read_text()
    out = cuda_build.BUILD_DIR / "phases17"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in (*CUTS, "whole", *VARIANTS):
        text = src
        if name in CUTS:
            assert CUTS[name] in text, name
            cut = CUTS[name].replace("grid.sync();", "grid.sync();\n    if (p.O >= 0) return;", 1)
            text = text.replace(CUTS[name], cut, 1)
        if name in VARIANTS:
            old, new = VARIANTS[name]
            assert old in text, name
            text = text.replace(old, new, 1)
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
        fn = ctypes.CDLL(str(lib)).covins_covis_weights
        fn.argtypes = cuda_build.SIGNATURES["covis_weights"]["covins_covis_weights"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_k17_phases: no CUDA card", file=sys.stderr)
        return 2
    smoke = _module("smoke", ROOT / "chip_smoke.py")
    from covins_tpu_torch import cuda_build
    from covins_tpu_torch.ops import covisibility as cov

    print(smoke.card_line())
    fns = build(cuda_build)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    exact = True
    for case in smoke.K17_SMOKE_CASES:
        n_kf, n_lm = case[:2]
        host = [torch.from_numpy(x) for x in smoke.k17_inputs(rng, *case)]
        q, kf, lm, mask = (x.to(dev) for x in host)
        Q, O = q.numel(), kf.numel()
        out = torch.empty((Q, n_kf), dtype=torch.int32, device=dev)
        scratch = torch.empty(cov.k17_scratch_len(Q, n_kf, n_lm), dtype=torch.int32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = cov.covis_weights_batch_plain(q, kf, lm, mask, n_kf, n_lm)
        row = {"case": list(case), "shape": [Q, n_kf, n_lm, O]}
        for name, fn in fns.items():
            def call(fn=fn):
                cuda_build.check(fn(q.data_ptr(), Q, kf.data_ptr(), lm.data_ptr(),
                                    mask.data_ptr(), O, n_kf, n_lm, scratch.data_ptr(),
                                    scratch.numel(), out.data_ptr(), stream), "covis_weights")

            row[f"{name}_us"] = smoke.busy_ms(call, 20) * 1e3
            if name not in CUTS:
                call()
                row[f"{name}_exact"] = torch.equal(out, want)
                exact &= row[f"{name}_exact"]
        print(json.dumps(row), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
