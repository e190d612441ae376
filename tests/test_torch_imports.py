"""The port and its chip check import neither JAX nor the JAX package, and
no port module imports OpenCV when it is imported (the agents import it
inside the functions that need it, agent-side).

Runs in a subprocess, because this test process already imported JAX
(tests/conftest.py).
"""

import ast
import os
import pkgutil
import subprocess
import sys

import covins_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        covins_tpu_torch.__path__, "covins_tpu_torch."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    for name in ("models.session", "models.placerec", "models.map_manager",
                 "ops.loopverify", "ops.projmatch", "ops.pnp", "ops.pgo",
                 "ops.relpose", "ops.residuals", "ops.polynomial", "ops.ransac",
                 "ops.linalg", "ops.gba", "ops.imu", "utils.geometry",
                 "utils.cameras", "utils.synthetic", "comm.wire", "comm.native_codec",
                 "comm.cereal_bridge", "comm.client", "comm.server", "ops.covisibility",
                 "io.export", "cli", "__main__", "io.stream", "ops.dbow_import",
                 "agents.frontend_adapter", "agents.euroc_agent", "utils.fake_euroc"):
        assert f"covins_tpu_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'covins_tpu' or m.startswith('covins_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
        "assert 'cv2' not in sys.modules, 'a port module imports OpenCV'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_sources_import_nothing_of_jax_or_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.dirname(covins_tpu_torch.__file__)):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "covins_tpu"), (path, name)
