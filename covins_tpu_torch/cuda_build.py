"""Build and load the hand-written CUDA kernels of ``covins_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, then loaded with ``ctypes``.  Nothing is built at import
time: :func:`library` builds on first use, and :func:`build_all` starts one
``nvcc`` per source at once so a cold start pays for the slowest source
only.  The library file name carries a hash of the source, of every
``csrc`` header it includes and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures: every pointer and the stream are c_void_p, counts c_int /
# c_int64, thresholds c_float / c_double; every function returns
# cudaGetLastError() as an int
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F, _D = ctypes.c_float, ctypes.c_double
SIGNATURES = {
    "hamming_argmin": {
        "covins_hamming_argmin": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    },
    "landmark_attributes": {
        "covins_landmark_attributes": [_P] * 5 + [_I, _I, _D, _D, _P, _P, _P],
    },
    "bow_insert_score": {
        "covins_bow_insert_score": [_P] * 5 + [_I, _I, _I, _L, _I, _I, _P],
    },
    "hamming_ratio_match": {
        "covins_hamming_ratio_match": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _P, _P, _P],
        "covins_hamming_knn2": [_P, _I, _P, _I, _P, _P, _P],
    },
    "l2_match": {
        "covins_l2_argmin": [_P, _P, _I, _P, _I, _F, _P, _P, _P, _P, _P],
        "covins_l2_ratio_match": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P],
        "covins_l2_filter_debug": [_P, _I, _P, _I, _P, _P],
    },
    "relpose_ransac": {
        "covins_ray_ransac_score": [_P] * 7 + [_I, _I, _I, _D] + [_P] * 5,
        "covins_relpose_ransac_5pt": [_P] * 5 + [_I] * 4 + [_D] + [_P] * 4,
    },
    "hamming_mutual_nn": {
        "covins_hamming_mutual_nn": [_P, _P, _I, _P, _P, _I, _F, _P, _P, _P],
    },
    "project_match": {
        "covins_project_match": [_I, _P, _P, _I] + [_P] * 5 + [_I, _D, _D, _D]
                                + [_P] * 5 + [_I] + [_P] * 4 + [_I, _D, _D, _D, _I]
                                + [_P] * 4,
    },
    "p3p_ransac": {
        "covins_p3p_ransac": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _D] + [_P] * 9,
    },
    "pgo_matvec": {
        "covins_pgo_matvec": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _D, _P,
                              _P, _P],
        "covins_pgo_pcg": [_P] * 7 + [_I, _P, _P, _I, _D, _I, _P, _P, _P, _I, _P],
    },
    "gba_reproj_blocks": {
        "covins_gba_reproj_blocks": [_I, _I, _P, _P, _P, _I] + [_P] * 6 + [_I] * 3
                                    + [_P] * 3 + [_I, _P, _P, _D] + [_P] * 13
                                    + [_I, _P],
    },
    "gba_reduced_matvec": {
        "covins_gba_reduced_matvec": [_P] * 9 + [_I] + [_P] * 3 + [_I] * 4 + [_P] * 6,
        "covins_gba_pcg": [_P] * 11 + [_I] + [_P] * 3 + [_I] * 3 + [_P] * 4 + [_I]
                          + [_P] * 2 + [_P] * 4 + [_I] + [_P] * 2 + [_I] + [_P] * 7
                          + [_I, _P],
    },
    "imu_preintegrate": {
        "covins_imu_preintegrate": [_P] * 6 + [_I, _I, _D, _D] + [_P] * 7,
    },
    "redundancy_values": {
        "covins_redundancy_values": [_P, _P, _P, _I, _I, _I, _P, _L, _P, _P],
    },
    "dbow_descend": {
        "covins_dbow_descend": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    },
}
# the most blocks a PCG kernel's grid may have: the size of the block slots
# its wrapper allocates for the dot products' partial sums
SLOT_CAP = 2048
# sources whose float arithmetic must round as the plain versions'
# separate tensor operations do: no fused multiply-add contraction
EXTRA_FLAGS = {
    "landmark_attributes": ["--fmad=false"],
    "bow_insert_score": ["--fmad=false"],
    "l2_match": ["--fmad=false"],
    "project_match": ["--fmad=false"],
    "p3p_ransac": ["--fmad=false"],
    "relpose_ransac": ["--fmad=false"],
    "pgo_matvec": ["--fmad=false"],
    "gba_reproj_blocks": ["--fmad=false"],
    "gba_reduced_matvec": ["--fmad=false"],
    "imu_preintegrate": ["--fmad=false"],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return found


def _flags(name: str) -> list:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """The source ``csrc/<name>.cu`` and every header of ``csrc`` it
    includes, directly or through another header, in the order first
    met."""
    seen = [CSRC / f"{name}.cu"]
    for path in seen:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists() and dep not in seen:
                seen.append(dep)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def _load(name: str, out: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named source in parallel; returns each ``nvcc`` log
    (register and shared-memory use from ``-Xptxas -v``)."""
    with _lock:
        names = [n for n in names if n not in _libs]
        jobs = {n: _start(n) for n in names}
        logs = {}
        for n, (out, job) in jobs.items():
            logs[n] = _finish(n, out, job)
            _load(n, out)
        return logs


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
