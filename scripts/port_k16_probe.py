#!/usr/bin/env python3
"""Time K16 (the DBoW2 vocabulary-tree descent) of the PyTorch port on one
CUDA card.

    python scripts/port_k16_probe.py [--tree DIR]

``--tree`` imports ``covins_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so that two versions can be
compared in one run on one card, in turns; the trees, the descriptors
(``utils/synthetic.dbow_tree`` and ``dbow_descriptors`` of this checkout,
from a seed) and the timing (``chip_smoke.k16_case``: bit for bit with the
plain version on the card, the mean time between back-to-back calls, the
card's busy time per call, the bound) come from this checkout either way.
A checkout whose K16 reads a child-block table (``dbow_import.child_blocks``)
gets the table built once a tree, with its bytes and build time printed.
Shapes: ORBvoc.txt's (k 10, L 6, 1,111,111 nodes) with 6,480 and 65,536
descriptors, and nodes wider than 16 children (k 17 and 32, L 3).  Then,
on ORBvoc's tree, what sets the time: the same descriptors taken only L
= 0, 1 and 3 levels down (L = 0 reads the descriptors and writes the
results only), and at L = 6 descriptors drawn from 64 distinct ones (a few
paths, whose blocks stay in L1 and L2).  Prints the card's name and power
limit, then one JSON line per shape.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CASES = ((10, 6, 6480), (10, 6, 65536), (17, 3, 3000), (32, 3, 4000))


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
    smoke = _module("smoke", ROOT / "chip_smoke.py")
    synthetic = _module("k16_synthetic", ROOT / "covins_tpu_torch" / "utils" / "synthetic.py")
    import torch

    if not torch.cuda.is_available():
        print("port_k16_probe: no CUDA card", file=sys.stderr)
        return 2
    from covins_tpu_torch.ops import dbow_import

    print(smoke.card_line())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(16)
    for k, L, N in CASES:
        voc = synthetic.dbow_tree(rng, k, L)
        descs = torch.from_numpy(synthetic.dbow_descriptors(rng, voc, N)).to(dev)
        tree = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            voc.children, voc.node_desc, voc.node_weight, voc.leaf_word_id))
        row = {"tree": args.tree, "k": k, "L": L, "N": N}
        table = {}
        if hasattr(dbow_import, "child_blocks"):
            t0 = time.perf_counter()
            blocks = dbow_import.child_blocks(voc.children, voc.node_desc).to(dev)
            torch.cuda.synchronize()
            row["table_build_s"] = time.perf_counter() - t0
            row["table_bytes"] = sum(x.numel() * x.element_size()
                                     for x in (blocks.rows, blocks.nxt, blocks.node_of))
            table["blocks"] = blocks
        r = smoke.k16_case(tree, L, descs, None, reps=50, cpu=False, **table)
        print(json.dumps({**row, **{key: r[key] for key in ("kernel_ms", "busy_ms",
                                                              "bound_ms", "plain_ms")}}))
        if (k, L) != (10, 6):
            continue
        few = descs[torch.from_numpy(rng.integers(0, 64, N)).to(dev)].contiguous()
        for depth, d, what in ((0, descs, "random"), (1, descs, "random"),
                               (3, descs, "random"), (L, few, "64 distinct")):
            r = smoke.k16_case(tree, depth, d, None, reps=50, cpu=False, **table)
            print(json.dumps({"tree": args.tree, "k": k, "L": depth, "N": N,
                              "descriptors": what, "busy_ms": r["busy_ms"],
                              "bound_ms": r["bound_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
