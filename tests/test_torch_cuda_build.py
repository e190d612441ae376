"""The kernel build's cache key (`covins_tpu_torch/cuda_build.py`), on the
CPU: a library's file name follows its source, every header of ``csrc``
the source includes (directly or through another header) and the flags,
so an edited header is rebuilt and not loaded stale.  No nvcc is run."""

import pytest

from covins_tpu_torch import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n// k\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    return tmp_path


@pytest.mark.parametrize("edited,changes", [("k.cu", True), ("a.cuh", True),
                                            ("b.cuh", True), ("other.cuh", False)])
def test_build_target_follows_included_headers(csrc, edited, changes):
    before = cuda_build._target("k")
    assert cuda_build._target("k") == before
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    assert (cuda_build._target("k") != before) == changes


def test_kernel_sources_include_the_shared_geometry():
    for name in ("project_match", "gba_reproj_blocks"):
        assert [p.name for p in cuda_build._sources(name)] == [
            f"{name}.cu", "coop_launch.cuh", "geometry.cuh"]
    for name in ("pgo_matvec", "gba_reduced_matvec", "hamming_mutual_nn", "p3p_ransac"):
        assert [p.name for p in cuda_build._sources(name)] == [f"{name}.cu", "coop_launch.cuh"]
    for name in cuda_build.SIGNATURES:
        assert all(p.exists() for p in cuda_build._sources(name))
