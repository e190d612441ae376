"""Tests of the benchmark's harness.  Run from the root of a checkout:

    python -m pytest portbench/tests -q

CPU tests use small shapes; tests marked ``card`` decide inside the test
whether a CUDA card is present and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
