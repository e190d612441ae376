"""The port's synthetic world against the JAX package's.

The streams themselves are compared in test_torch_session.py, where the
JAX package's agents already run.  Here: the camera extrinsic to 1e-15
and the world's shape, types and extent.
"""

import numpy as np

from covins_tpu.agents import synthetic_agent as ref_agent
from covins_tpu_torch.agents import synthetic_agent as port_agent


def test_camera_extrinsic_matches_reference():
    np.testing.assert_allclose(port_agent.FORWARD_T_S_C,
                               ref_agent._forward_camera_extrinsic(),
                               rtol=0, atol=1e-15)


def test_world_statistics_match_reference():
    ref = ref_agent.SyntheticWorld.create(n_landmarks=500, seed=0)
    got = port_agent.SyntheticWorld.create(n_landmarks=500, seed=0)
    assert got.landmarks.shape == ref.landmarks.shape
    assert got.lm_descs.shape == ref.lm_descs.shape
    assert got.lm_descs.dtype == ref.lm_descs.dtype
    lo, hi = np.asarray(ref.landmarks).min(0), np.asarray(ref.landmarks).max(0)
    assert (got.landmarks.min(0) >= lo - 0.5).all()
    assert (got.landmarks.max(0) <= hi + 0.5).all()
    assert got.calib.intrinsics.tolist() == ref.calib.intrinsics.tolist()
