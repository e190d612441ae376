"""The port's IMU preintegration against the JAX package's.

Inputs are made with numpy from a seed: four factors of 60 samples of
specific force around gravity and angular rate, with ragged validity masks
(one factor fully valid, one with a single sample), propagated at nonzero
biases.  Both packages integrate the same float64 samples with the same
midpoint scheme, and both take the bias Jacobian by forward-mode
differentiation through the sample loop, so every output agrees to 1e-12
relative to its largest entry (they round apart only where the two
libraries order a sum or a norm differently, about 1e-16).  On the CPU the
port runs the plain version of K10; the kernel itself is held to the plain
version on the card (`tests/test_torch_kernels_cuda.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import imu as ref_imu
from covins_tpu_torch.ops import imu
from covins_tpu_torch.state import preintegrated_from_reference

FIELDS = ("dq", "dv", "dp", "J_q_bg", "J_v_bg", "J_v_ba", "J_p_bg", "J_p_ba", "cov",
          "dt", "bg_ref", "ba_ref")
F, S = 4, 60


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(7)
    acc = rng.normal(scale=0.5, size=(F, S, 3)) + [0.3, -0.2, 9.81]
    gyro = rng.normal(scale=0.3, size=(F, S, 3))
    dts = rng.uniform(0.004, 0.006, (F, S))
    n_valid = np.asarray([S, 37, 1, 52])
    mask = (np.arange(S)[None, :] < n_valid[:, None]).astype(np.float64)
    bg = rng.normal(scale=0.01, size=(F, 3))
    ba = rng.normal(scale=0.05, size=(F, 3))
    return acc, gyro, dts, mask, bg, ba


@pytest.fixture(scope="module")
def both(samples):
    noise = ref_imu.default_noise()
    ref = jax.vmap(lambda a, g, d, m, bg, ba: ref_imu.preintegrate(a, g, d, m, bg, ba, noise))(
        *(jnp.asarray(x) for x in samples))
    got = imu.preintegrate(*(torch.tensor(x) for x in samples), imu.default_noise())
    return ref, got


def test_default_noise_matches_reference():
    ref = ref_imu.default_noise()
    port = imu.default_noise()
    for name in ("acc_noise", "gyro_noise", "acc_walk", "gyro_walk"):
        assert getattr(port, name) == float(getattr(ref, name))


@pytest.mark.parametrize("field", FIELDS)
def test_preintegrate_matches_reference(both, field):
    ref, got = both
    assert _rel(getattr(got, field).numpy(), getattr(ref, field)) <= 1e-12


def test_preintegrated_from_reference_roundtrip(both):
    ref, _ = both
    pre = preintegrated_from_reference(ref, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(pre, name).numpy(), np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("theta", [0.0, 3e-6, 0.4])
def test_right_jacobian_matches_reference(theta):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(5, 3))
    v = theta * v / np.linalg.norm(v, axis=1, keepdims=True)
    ref = np.asarray(jax.vmap(ref_imu._right_jacobian)(jnp.asarray(v)))
    assert _rel(imu._right_jacobian(torch.tensor(v)).numpy(), ref) <= 1e-12


def test_bias_corrected_delta_and_residual_match_reference(both):
    """`bias_corrected_delta` and `imu_residual` at moved biases, on random
    poses and velocities, batched over the four factors."""
    ref, got = both
    rng = np.random.default_rng(3)

    def pose():
        q = rng.normal(size=(F, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([q * np.sign(q[:, :1]), rng.normal(size=(F, 3))], 1)

    pi, pj = pose(), pose()
    vi, vj = rng.normal(size=(F, 3)), rng.normal(size=(F, 3))
    bg = np.asarray(ref.bg_ref) + rng.normal(scale=1e-3, size=(F, 3))
    ba = np.asarray(ref.ba_ref) + rng.normal(scale=1e-2, size=(F, 3))
    grav = np.asarray([0.0, 0.0, -9.81])
    r_ref = jax.vmap(lambda pre, a, b, c, d, e, f: ref_imu.imu_residual(
        pre, a, b, c, d, e, f, gravity=jnp.asarray(grav)))(
        ref, *(jnp.asarray(x) for x in (pi, vi, bg, ba, pj, vj)))
    d_ref = jax.vmap(ref_imu.bias_corrected_delta)(ref, jnp.asarray(bg), jnp.asarray(ba))
    t = torch.tensor
    r = imu.imu_residual(got, t(pi), t(vi), t(bg), t(ba), t(pj), t(vj), gravity=t(grav))
    d = imu.bias_corrected_delta(got, t(bg), t(ba))
    assert _rel(r.numpy(), r_ref) <= 1e-12
    for a, b in zip(d, d_ref):
        assert _rel(a.numpy(), b) <= 1e-12
    # the default gravity is the reference's
    r0 = imu.imu_residual(got, t(pi), t(vi), t(bg), t(ba), t(pj), t(vj))
    assert _rel(r0.numpy(), r_ref) <= 1e-12


def test_fuse_samples_matches_reference(samples):
    """Joining two windows, then re-propagating, as keyframe culling does:
    the same arrays as the reference's concatenation, and the fused
    factor's preintegration agrees with the reference's to 1e-12."""
    acc, gyro, dts, mask, bg, ba = samples
    ref = ref_imu.fuse_samples(*(jnp.asarray(x) for x in (acc[0], gyro[0], dts[0], mask[0],
                                                          acc[1], gyro[1], dts[1], mask[1])))
    got = imu.fuse_samples(*(torch.tensor(x) for x in (acc[0], gyro[0], dts[0], mask[0],
                                                       acc[1], gyro[1], dts[1], mask[1])))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    noise = ref_imu.default_noise()
    pre_ref = ref_imu.preintegrate(*ref, jnp.asarray(bg[0]), jnp.asarray(ba[0]), noise)
    pre = imu.preintegrate(*(x[None] for x in got), torch.tensor(bg[:1]),
                           torch.tensor(ba[:1]), imu.default_noise())
    for name in FIELDS:
        assert _rel(getattr(pre, name)[0].numpy(), getattr(pre_ref, name)) <= 1e-12, name
