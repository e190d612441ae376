"""One short run of each cell on a CUDA card (skips without one)."""

import json
import subprocess
import sys

import pytest

from portbench.harness.drive import PB


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (PB.parent / "BENCHMARK.json").read_text())["workloads"]])
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", cell, "--seed",
                          "3000000099", "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=PB.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
