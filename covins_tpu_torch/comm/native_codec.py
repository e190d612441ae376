"""ctypes bindings for the native wire codec (`native/wirecodec.cpp`).

Counterpart of `covins_tpu/comm/native_codec.py`.  The shared library is
built on first use with ``g++ -O3 -std=c++17 -fPIC -shared`` (the flags of
`native/Makefile`) from the repository's `native/wirecodec.cpp` into the
port's own build directory (`build/kernels/`, beside the CUDA kernels),
named with a hash of the source and the flags, so an edited source is
rebuilt; nothing is written under `native/`.  The C API is plain pointers
and offsets; numpy wraps the results zero-copy.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from covins_tpu_torch.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wirecodec.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

KIND_ARRAY, KIND_STR, KIND_NONE = 0, 1, 2


def library_path() -> Path:
    """Where the built library goes: its name carries a hash of the source
    and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwirecodec-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless this source was built already; raises with
    the compiler's output when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


class NativeCodec:
    def __init__(self, lib):
        self.lib = lib
        lib.cvns_encode_record.restype = C.c_int64
        lib.cvns_count_fields.restype = C.c_int32
        lib.cvns_decode_record.restype = C.c_int32
        lib.cvns_stream_new.restype = C.c_void_p
        lib.cvns_stream_base.restype = C.POINTER(C.c_uint8)
        lib.cvns_stream_next.restype = C.c_int32

    # ------------------------------------------------------------- encode
    def encode_record(self, rec: Dict[str, object]) -> bytes:
        n = len(rec)
        names, name_lens, kinds = [], [], []
        dtypes, dtype_lens, ndims = [], [], []
        shapes, datas, data_lens = [], [], []
        keep_alive = []
        for name, val in rec.items():
            nb = name.encode()
            names.append(nb)
            name_lens.append(len(nb))
            if val is None:
                kinds.append(KIND_NONE)
                dtypes.append(b""); dtype_lens.append(0); ndims.append(0)
                datas.append(None); data_lens.append(0)
            elif isinstance(val, str):
                vb = val.encode()
                keep_alive.append(vb)
                kinds.append(KIND_STR)
                dtypes.append(b""); dtype_lens.append(0); ndims.append(0)
                datas.append(vb); data_lens.append(len(vb))
            else:
                # match wire.encode_record: scalars stay 0-d
                arr = np.asarray(val)
                if arr.ndim:
                    arr = np.ascontiguousarray(arr)
                keep_alive.append(arr)
                ds = arr.dtype.str.encode()
                kinds.append(KIND_ARRAY)
                dtypes.append(ds); dtype_lens.append(len(ds))
                ndims.append(arr.ndim)
                shapes.extend(arr.shape)
                datas.append(arr); data_lens.append(arr.nbytes)

        c_names = (C.c_char_p * n)(*names)
        c_name_lens = (C.c_uint16 * n)(*name_lens)
        c_kinds = (C.c_uint8 * n)(*kinds)
        c_dtypes = (C.c_char_p * n)(*dtypes)
        c_dtype_lens = (C.c_uint8 * n)(*dtype_lens)
        c_ndims = (C.c_uint8 * n)(*ndims)
        c_shapes = (C.c_int64 * max(len(shapes), 1))(*(shapes or [0]))
        c_data = (C.c_void_p * n)()
        for i, d in enumerate(datas):
            if d is None:
                c_data[i] = None
            elif isinstance(d, bytes):
                c_data[i] = C.cast(C.c_char_p(d), C.c_void_p)
            else:
                c_data[i] = d.ctypes.data_as(C.c_void_p).value
        c_data_lens = (C.c_int64 * n)(*data_lens)

        cap = 2 + sum(
            2 + name_lens[i] + 1
            + (1 + dtype_lens[i] + 1 + 8 * ndims[i] + data_lens[i]
               if kinds[i] == KIND_ARRAY else 4 + data_lens[i])
            for i in range(n)
        ) + 64
        out = C.create_string_buffer(cap)
        written = self.lib.cvns_encode_record(
            n, c_names, c_name_lens, c_kinds, c_dtypes, c_dtype_lens,
            c_ndims, c_shapes, c_data, c_data_lens,
            C.cast(out, C.POINTER(C.c_uint8)), cap,
        )
        if written < 0:
            raise RuntimeError("native encode overflow")
        return out.raw[:written]

    # ------------------------------------------------------------- decode
    def decode_record(self, buf) -> Dict[str, object]:
        mv = memoryview(buf)
        raw = bytes(mv) if not isinstance(buf, (bytes, bytearray)) else buf
        blen = len(raw)
        cbuf = (C.c_uint8 * blen).from_buffer_copy(raw)
        n = self.lib.cvns_count_fields(cbuf, blen)
        if n < 0:
            raise ValueError("malformed record")
        shapes_cap = 8 * max(n, 1)
        name_offs = (C.c_int64 * n)()
        name_lens = (C.c_uint16 * n)()
        kinds = (C.c_uint8 * n)()
        dtype_offs = (C.c_int64 * n)()
        dtype_lens = (C.c_uint8 * n)()
        ndims = (C.c_uint8 * n)()
        shapes = (C.c_int64 * shapes_cap)()
        data_offs = (C.c_int64 * n)()
        data_lens = (C.c_int64 * n)()
        rc = self.lib.cvns_decode_record(
            cbuf, blen, n, shapes_cap,
            name_offs, name_lens, kinds, dtype_offs, dtype_lens,
            ndims, shapes, data_offs, data_lens,
        )
        if rc != 0:
            raise ValueError(f"malformed record (rc={rc})")
        rec: Dict[str, object] = {}
        s_off = 0
        for i in range(n):
            name = raw[name_offs[i] : name_offs[i] + name_lens[i]].decode()
            if kinds[i] == KIND_NONE:
                rec[name] = None
            elif kinds[i] == KIND_STR:
                rec[name] = raw[data_offs[i] : data_offs[i] + data_lens[i]].decode()
            else:
                dt = np.dtype(
                    raw[dtype_offs[i] : dtype_offs[i] + dtype_lens[i]].decode()
                )
                shp = tuple(shapes[s_off : s_off + ndims[i]])
                s_off += ndims[i]
                arr = np.frombuffer(
                    raw, dtype=dt, count=(int(np.prod(shp)) if shp else 1),
                    offset=data_offs[i],
                ).reshape(shp)
                rec[name] = arr if shp else arr[()]
        return rec

    # -------------------------------------------------------------- stream
    def stream_new(self):
        return self.lib.cvns_stream_new()

    def stream_free(self, s):
        self.lib.cvns_stream_free(C.c_void_p(s))

    def stream_feed(self, s, data: bytes):
        self.lib.cvns_stream_feed(C.c_void_p(s), data, len(data))

    def stream_next(self, s):
        """Returns (msg_type, payload bytes) or None."""
        mt = C.c_uint8()
        off = C.c_int64()
        plen = C.c_int64()
        rc = self.lib.cvns_stream_next(C.c_void_p(s), C.byref(mt),
                                       C.byref(off), C.byref(plen))
        if rc == 0:
            return None
        if rc < 0:
            raise ValueError("bad frame in stream")
        base = self.lib.cvns_stream_base(C.c_void_p(s))
        payload = C.string_at(C.addressof(base.contents) + off.value, plen.value)
        return int(mt.value), payload


def load(lib_path: Optional[str] = None) -> Optional[NativeCodec]:
    """The codec from ``lib_path``, or built from the repository's source;
    None when the source or the compiler is missing or the build fails."""
    try:
        path = Path(lib_path) if lib_path else build()
        return NativeCodec(C.CDLL(str(path)))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
