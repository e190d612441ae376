"""Build and load the hand-written CUDA kernels of ``covins_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, then loaded with ``ctypes``.  Nothing is built at import
time: :func:`library` builds on first use, and :func:`build_all` starts one
``nvcc`` per source at once so a cold start pays for the slowest source
only.  The library file name carries a hash of the source and flags, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
    "representative_descriptors": {
        "covins_representative_descriptors": [_P, _P, _I, _I, _P, _P],
    },
    "bow_insert": {
        "covins_bow_insert": [_P, _P, _P, _P, _I, _I, _I, _L, _P],
    },
    "hamming_mutual_nn": {
        "covins_hamming_mutual_nn": [_P, _P, _I, _P, _P, _I, _F,
                                     _P, _P, _P, _P, _P, _P],
    },
    "project_match": {
        "covins_project_match": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                                 _I, _F, _P, _P, _P, _P, _P, _P],
    },
    "p3p_score": {
        "covins_p3p_score": [_P, _P, _P, _P, _P, _I, _I, _D, _P, _P, _P, _P,
                             _P],
    },
    "pgo_matvec": {
        "covins_pgo_matvec": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _D, _P,
                              _P, _P],
        "covins_pgo_pcg": [_P] * 7 + [_I, _P, _P, _I, _D, _I, _P, _P, _P, _I, _P],
    },
    "gba_reproj_blocks": {
        "covins_gba_reproj_blocks": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                     _P, _P, _I, _P, _P, _I, _D] + [_P] * 10,
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
}
# the most blocks a PCG kernel's grid may have: the size of the block slots
# its wrapper allocates for the dot products' partial sums
SLOT_CAP = 2048
# sources whose float64 arithmetic must round as the plain versions'
# separate tensor operations do: no fused multiply-add contraction
EXTRA_FLAGS = {
    "project_match": ["--fmad=false"],
    "p3p_score": ["--fmad=false"],
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


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
