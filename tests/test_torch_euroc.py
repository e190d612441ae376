"""The port's EuRoC replay agent, fake-EuRoC renderer and CFS recorder
against the JAX package's, on the CPU (OpenCV needed: skipped without).

* `utils/fake_euroc.write_fake_sequence`: one sequence of 14 keyframes
  rendered by each package.  `cam0/data.csv` byte for byte; the IMU and
  ground-truth CSVs line for line with every timestamp byte for byte and
  every float within 1e-12: their values come from `utils/synthetic.
  generate`, whose trajectory the port computes with `torch.func` and the
  JAX package with `jax.jacfwd`, one float64 ulp apart (measured: poses
  1.1e-16, accelerometer samples 7.1e-15), so their decimal text differs
  in the last digits; `fake_truth.npz` within 1e-12; the PNGs pixel for
  pixel (measured: no pixel differs).
* `agents/euroc_agent.EurocAgent` on the JAX-rendered sequence, with
  `pose_drift` 0 and 0.03: every message equal, in order (host numpy and
  OpenCV in both).
* `scripts/port_record_cfs.py` writes `scripts/record_cfs.py`'s bytes.
"""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from covins_tpu.agents.euroc_agent import EurocAgent as RefAgent  # noqa: E402
from covins_tpu.utils import fake_euroc as ref_fake  # noqa: E402
from covins_tpu_torch.agents.euroc_agent import EurocAgent  # noqa: E402
from covins_tpu_torch.comm import messages as msgs  # noqa: E402
from covins_tpu_torch.io import stream as cfs  # noqa: E402
from covins_tpu_torch.utils import fake_euroc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KF = 14
CSV_TOL = 1e-12
SEQ_KW = dict(n_keyframes=N_KF, n_landmarks=300, seed=1)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    d = tmp_path_factory.mktemp("fake_euroc")
    return (ref_fake.write_fake_sequence(str(d / "ref"), **SEQ_KW),
            fake_euroc.write_fake_sequence(str(d / "port"), **SEQ_KW))


def _assert_equal(a, b, where="message"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _csv_rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split(",") for line in fh]


def test_fake_sequence_matches_reference(sequences):
    ref, port = (os.path.join(s, "mav0") for s in sequences)
    cam = os.path.join("cam0", "data.csv")
    assert filecmp.cmp(os.path.join(ref, cam), os.path.join(port, cam), shallow=False)
    for rel in (os.path.join("imu0", "data.csv"),
                os.path.join("state_groundtruth_estimate0", "data.csv")):
        r_rows, p_rows = _csv_rows(os.path.join(ref, rel)), _csv_rows(os.path.join(port, rel))
        assert r_rows[0] == p_rows[0] and len(r_rows) == len(p_rows) > N_KF
        assert [r[0] for r in r_rows] == [p[0] for p in p_rows]  # timestamps
        np.testing.assert_allclose(np.asarray([p[1:] for p in p_rows[1:]], float),
                                   np.asarray([r[1:] for r in r_rows[1:]], float),
                                   rtol=0, atol=CSV_TOL, err_msg=rel)
    r_npz, p_npz = (np.load(os.path.join(s, "fake_truth.npz")) for s in (ref, port))
    assert sorted(r_npz.files) == sorted(p_npz.files)
    for k in r_npz.files:
        assert r_npz[k].dtype == p_npz[k].dtype
        np.testing.assert_allclose(p_npz[k], r_npz[k], rtol=0, atol=CSV_TOL, err_msg=k)
    names = sorted(os.listdir(os.path.join(ref, "cam0", "data")))
    assert names == sorted(os.listdir(os.path.join(port, "cam0", "data")))
    assert len(names) == N_KF
    for name in names:
        a, b = (cv2.imread(os.path.join(s, "cam0", "data", name), cv2.IMREAD_UNCHANGED)
                for s in (ref, port))
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("drift", [0.0, 0.03])
def test_euroc_agent_messages_match_reference(sequences, drift):
    seq = sequences[0]
    ref = list(RefAgent(seq, client_id=1, pose_drift=drift).messages())
    port = list(EurocAgent(seq, client_id=1, pose_drift=drift).messages())
    assert len(port) == len(ref)
    kinds = [type(m).__name__ for m in port]
    assert kinds.count("MsgKeyframe") >= 8 and kinds.count("MsgLandmark") >= 50
    for i, (r, p) in enumerate(zip(ref, port)):
        _assert_equal(r, p, f"message {i}")
    assert isinstance(port[0], msgs.MsgKeyframe) and port[0].calibration is not None


def test_record_cfs_matches_reference(sequences, tmp_path):
    seq = sequences[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for name in ("record_cfs.py", "port_record_cfs.py"):
        path = str(tmp_path / f"{name}.cfs")
        r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", name),
                            "--euroc", seq, "--out", path, "--with-imu"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(path, "rb") as fh:
            out[name] = fh.read()
    assert out["record_cfs.py"] == out["port_record_cfs.py"]
    recs = list(cfs.read_stream(str(tmp_path / "port_record_cfs.py.cfs")))
    assert [r["kind"] for r in recs] == ["calib"] + ["frame"] * N_KF
    assert recs[0]["dist_model"] == 1 and "acc" in recs[2]
