"""The port's wire codec, native codec and cereal bridge against the JAX
package's, byte for byte.

The JAX package's synthetic agent (with ``send_updates=True``, so every
message type occurs) makes the stream; `messages_from_reference` hands the
same messages to the port.  Expected: the port's frames and cereal
containers are the reference's bytes exactly; each package decodes the
other's bytes to equal fields; the port's native codec, built from
`native/wirecodec.cpp` into the port's `build/kernels/`, gives the Python
codec's bytes and reassembles split frames; and the port's synthetic agent
makes the reference's update stream on the reference's world (floats to
1e-9, the tolerance `tests/test_torch_session.py` states for the agents).
"""

import dataclasses

import numpy as np
import pytest

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.comm import cereal_bridge as ref_cb
from covins_tpu.comm import messages as ref_msgs
from covins_tpu.comm import wire as ref_wire
from covins_tpu_torch import cuda_build
from covins_tpu_torch.agents import synthetic_agent as port_agent
from covins_tpu_torch.comm import cereal_bridge as cb
from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.comm import native_codec
from covins_tpu_torch.comm import wire
from covins_tpu_torch.state import messages_from_reference

N_KF = 5
KINDS = ("MsgKeyframe", "MsgKeyframeUpdate", "MsgLandmark", "MsgLandmarkUpdate")


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld.create(n_landmarks=200, seed=4)


@pytest.fixture(scope="module")
def stream(world):
    """The reference stream with the update plane, and the port's copy."""
    agent = SyntheticAgent(world, client_id=1, n_keyframes=N_KF, send_updates=True,
                           update_window_size=2)
    ref = list(agent.messages())
    return ref, messages_from_reference(ref)


def _with_add(ref_kf):
    """A keyframe that also carries the additional feature set."""
    n = len(ref_kf.keypoints)
    rng = np.random.default_rng(0)
    return dataclasses.replace(
        ref_kf, keypoints_add=rng.random((n + 3, 2)).astype(np.float32),
        keypoints_aors_add=rng.random((n + 3, 4)).astype(np.float32),
        descriptors_add=rng.integers(0, 256, (n + 3, 32), dtype=np.uint8))


def _same(a, b, name):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, name
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{name}.{f.name}")
    elif isinstance(a, dict):
        assert {tuple(k): v for k, v in a.items()} == {tuple(k): v for k, v in b.items()}, name
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    elif isinstance(a, tuple) or isinstance(b, tuple):
        assert tuple(a) == tuple(b), name
    else:
        assert a == b, name


@pytest.mark.parametrize("kind", KINDS + ("MsgKeyframe_add",))
def test_frames_are_the_reference_bytes(stream, kind):
    ref, port = stream
    pairs = [(r, p) for r, p in zip(ref, port) if type(r).__name__ == kind.split("_")[0]]
    if kind == "MsgKeyframe_add":
        pairs = [(_with_add(r), messages_from_reference(_with_add(r))) for r, _ in pairs[:2]]
    assert pairs
    for r, p in pairs:
        assert wire.encode_message(p) == ref_wire.encode_message(r)


@pytest.mark.parametrize("direction", ["port_reads_reference", "reference_reads_port"])
def test_each_package_decodes_the_other(stream, direction):
    ref, port = stream
    enc, dec = ((ref_wire, wire) if direction == "port_reads_reference"
                else (wire, ref_wire))
    src = ref if direction == "port_reads_reference" else port
    for i, m in enumerate(src + [_with_add(ref[0])]):
        if direction == "reference_reads_port" and i == len(src):
            m = messages_from_reference(m)
        blob = enc.encode_message(m)
        msg_type, plen = dec.parse_header(blob[: dec.HEADER_SIZE])
        assert plen == len(blob) - dec.HEADER_SIZE
        out = dec.decode_message(msg_type, memoryview(blob[dec.HEADER_SIZE:]))
        _same(enc.decode_message(msg_type, memoryview(blob[enc.HEADER_SIZE:])), out, f"msg{i}")


def test_record_roundtrip():
    rec = {"f64": np.arange(12, dtype=np.float64).reshape(3, 4),
           "u8": np.arange(8, dtype=np.uint8), "scalar": np.float64(3.5),
           "i64pair": np.asarray([3, 1], np.int64), "name": "hello world",
           "nothing": None}
    buf = wire.encode_record(rec)
    assert buf == ref_wire.encode_record(rec)
    out = wire.decode_record(memoryview(buf))
    assert set(out) == set(rec)
    np.testing.assert_array_equal(out["f64"], rec["f64"])
    assert float(out["scalar"]) == 3.5 and out["name"] == "hello world"
    assert out["nothing"] is None
    with pytest.raises(ValueError, match="bad magic"):
        wire.parse_header(b"\0" * wire.HEADER_SIZE)


# ------------------------------------------------------------ native codec

@pytest.fixture(scope="module")
def codec():
    c = native_codec.load()
    assert c is not None, "the native codec did not build (g++)"
    return c


def test_native_codec_builds_into_the_ports_build_directory(codec):
    path = native_codec.library_path()
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert "native" not in path.parent.parts


def test_native_codec_matches_python_on_messages(codec, stream):
    ref, port = stream
    for m in port:
        blob = wire.encode_message(m)
        payload = blob[wire.HEADER_SIZE:]
        rec_py = wire.decode_record(memoryview(payload))
        assert codec.encode_record(rec_py) == payload
        rec_n = codec.decode_record(payload)
        assert set(rec_n) == set(rec_py)
        for k, v in rec_py.items():
            if v is None or isinstance(v, str):
                assert rec_n[k] == v
            else:
                assert np.asarray(rec_n[k]).dtype == np.asarray(v).dtype
                np.testing.assert_array_equal(np.asarray(rec_n[k]), np.asarray(v))


def test_native_stream_reassembly(codec):
    """`tests/test_native_codec.py::test_stream_reassembly` on the port's
    build: frames fed in 7-byte chunks come out whole."""
    frames = [wire.frame(1, wire.encode_record({"x": np.arange(5, dtype=np.int32)})),
              wire.frame(2, wire.encode_record({"y": "hello"})),
              wire.frame(3, b"")]
    blob = b"".join(frames)
    s = codec.stream_new()
    try:
        got = []
        for i in range(0, len(blob), 7):
            codec.stream_feed(s, blob[i:i + 7])
            while (nxt := codec.stream_next(s)) is not None:
                got.append(nxt)
        assert [mt for mt, _ in got] == [1, 2, 3]
        np.testing.assert_array_equal(codec.decode_record(got[0][1])["x"],
                                      np.arange(5, dtype=np.int32))
        assert codec.decode_record(got[1][1])["y"] == "hello"
        assert got[2][1] == b""
    finally:
        codec.stream_free(s)


def test_use_native_switch(stream):
    import importlib

    _, port = stream
    before = [wire.encode_message(m) for m in port[:6]]
    assert wire.use_native()
    try:
        assert [wire.encode_message(m) for m in port[:6]] == before
    finally:
        importlib.reload(wire)


# ------------------------------------------------------------------ cereal

@pytest.mark.parametrize("kind", ["keyframe", "landmark", "container"])
def test_cereal_is_the_reference_bytes(stream, kind):
    ref, port = stream
    full = [(r, p) for r, p in zip(ref, port)
            if isinstance(r, (ref_msgs.MsgKeyframe, ref_msgs.MsgLandmark))]
    if kind == "keyframe":
        pairs = [(r, p) for r, p in full if isinstance(r, ref_msgs.MsgKeyframe)]
        pairs.append((_with_add(pairs[0][0]), messages_from_reference(_with_add(pairs[0][0]))))
        for r, p in pairs:
            assert cb.encode_keyframe(p) == ref_cb.encode_keyframe(r)
    elif kind == "landmark":
        for r, p in full:
            if isinstance(r, ref_msgs.MsgLandmark):
                assert cb.encode_landmark(p) == ref_cb.encode_landmark(r)
    else:
        for i in range(0, len(full), 10):
            chunk = full[i:i + 10]
            assert cb.encode_container([p for _, p in chunk]) == \
                ref_cb.encode_container([r for r, _ in chunk])
        assert cb.id_assignment(7) == ref_cb.id_assignment(7)


def test_cereal_roundtrip_and_recorded_stream(stream, tmp_path):
    ref, port = stream
    full = [m for m in port if isinstance(m, (msgs.MsgKeyframe, msgs.MsgLandmark))]
    kf = next(m for m in full if isinstance(m, msgs.MsgKeyframe))
    out = cb.decode_keyframe(cb.encode_keyframe(kf), is_update=False)
    _same(ref_cb.decode_keyframe(cb.encode_keyframe(kf), is_update=False), out, "kf")
    assert out.id == tuple(kf.id)
    np.testing.assert_array_equal(out.descriptors, kf.descriptors)
    np.testing.assert_allclose(out.T_sref_s, kf.T_sref_s, atol=1e-9)
    np.testing.assert_allclose(out.calibration.T_s_c, kf.calibration.T_s_c, atol=1e-9)
    lm = next(m for m in full if isinstance(m, msgs.MsgLandmark))
    out = cb.decode_landmark(cb.encode_landmark(lm), is_update=False)
    assert out.observations == {tuple(k): int(v) for k, v in lm.observations.items()}
    path = str(tmp_path / "ref_stream.bin")
    assert cb.record_stream(full, path) == ref_cb.record_stream(
        [m for m in ref if isinstance(m, (ref_msgs.MsgKeyframe, ref_msgs.MsgLandmark))],
        str(tmp_path / "ref_stream_jax.bin"))
    assert open(path, "rb").read() == open(tmp_path / "ref_stream_jax.bin", "rb").read()
    decoded = list(cb.iter_stream(path))
    assert [type(m).__name__ for m in decoded] == [type(m).__name__ for m in full]
    for i, (a, b) in enumerate(zip(ref_cb.iter_stream(path), decoded)):
        _same(a, b, f"stream{i}")


# ------------------------------------------------------- the update plane

def test_agent_update_stream_matches_reference(world):
    """The port's `SyntheticAgent(send_updates=True)` on the reference's
    world makes the reference's message stream."""
    kw = dict(n_keyframes=6, send_updates=True, update_window_size=3)
    ref = list(SyntheticAgent(world, 0, **kw).messages())
    pw = port_agent.SyntheticWorld(np.asarray(world.landmarks), np.asarray(world.lm_descs),
                                   messages_from_reference(world.calib))
    got = list(port_agent.SyntheticAgent(pw, 0, **kw).messages())
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in ref]
    assert {type(m).__name__ for m in got} == set(KINDS)
    for i, (r, g) in enumerate(zip(messages_from_reference(ref), got)):
        for f in dataclasses.fields(r):
            a, b = getattr(r, f.name), getattr(g, f.name)
            if isinstance(a, np.ndarray) and a.dtype.kind == "f":
                tol = 1e-4 if a.dtype == np.float32 else 1e-9
                np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=f"msg{i}.{f.name}")
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f"msg{i}.{f.name}")
            elif not dataclasses.is_dataclass(a):
                assert a == b, f"msg{i}.{f.name}"
