"""No run loads JAX or the JAX package; the reference imports nothing of
the program."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import cellrun
from portbench.harness.drive import PB


@pytest.mark.parametrize("name, bad", [
    ("covins_tpu_torch", False), ("covins_tpu_torch.ops.pgo", False), ("jaxfoo", False),
    ("covins_tpu", True), ("covins_tpu.ops.pgo", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib", True), ("flax.linen", True)])
def test_top_level_name_check(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(cellrun.forbidden_modules()) == bad


def test_reference_imports_no_program():
    for path in sorted((PB / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        # the reference's own modules, and nothing else of the repository
        tops = {m.split(".")[0] for m in mods if m and not m.startswith("portbench.reference")}
        assert tops <= {"__future__", "numpy", "torch"}, (path.name, tops)


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.harness.cellrun, portbench.control;"
            "import portbench.harness.drive as d; d.make_inputs;"
            "import covins_tpu_torch.models.session, covins_tpu_torch.models.map_manager;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'covins_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code, str(PB.parent)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "covins5.stream",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
