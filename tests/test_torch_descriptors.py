"""Port's Hamming ops (kernel K1's plain version) against the JAX package.

Hamming distances are integers, so every comparison here is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import descriptors as ref_desc
from covins_tpu_torch import device as dev_mod
from covins_tpu_torch.ops import bow, descriptors


def _inputs(seed, m=400, n=96):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b[17] = b[5]  # duplicate vocabulary rows: exact ties
    b[60] = b[5]
    a[:20] = b[5]  # queries sitting on the tied word
    a[20:30] = b[70] ^ np.uint8(1)  # near-ties one bit away
    mask = rng.random(m) > 0.25
    return a, b, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_argmin_matches_reference(seed):
    a, b, mask = _inputs(seed)
    d_ref = ref_desc.hamming_distance_best(jnp.asarray(a), jnp.asarray(b))
    idx_ref = np.asarray(jnp.argmin(d_ref, axis=1))
    dmin_ref = np.asarray(jnp.min(d_ref, axis=1))
    idx, dmin, dist = descriptors.hamming_argmin(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
        want_dist=True)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(dmin.numpy(), dmin_ref)
    np.testing.assert_array_equal(idx.numpy(), np.where(mask, idx_ref, -1))
    assert (idx.numpy()[:20][mask[:20]] == 5).all()  # lowest index wins ties
    assert idx.dtype == torch.int32 and dmin.dtype == torch.int32


def test_hamming_distance_and_xor_oracle_match_reference():
    a, b, _ = _inputs(2, m=150)
    ref = np.asarray(ref_desc.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    ref_xor = np.asarray(ref_desc.hamming_distance_xor(jnp.asarray(a),
                                                       jnp.asarray(b)))
    np.testing.assert_array_equal(
        descriptors.hamming_distance(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(), ref)
    np.testing.assert_array_equal(
        descriptors.hamming_distance_xor(torch.from_numpy(a),
                                         torch.from_numpy(b), chunk=64).numpy(),
        ref_xor)


def test_assign_words_matches_reference():
    a, b, mask = _inputs(3)
    ref = np.asarray(ref_bow.assign_words(jnp.asarray(a), jnp.asarray(b),
                                          mask=jnp.asarray(mask)))
    got = bow.assign_words(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kmedians_matches_reference_from_same_initial_centres():
    import jax

    rng = np.random.default_rng(4)
    descs = rng.integers(0, 256, (500, 32), dtype=np.uint8)
    k, iters, seed = 24, 3, 5
    # the reference draws its initial centres with jax.random; hand the
    # same draw to the port's refinement
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), 500, (k,),
                                        replace=False))
    ref = np.asarray(ref_bow.train_vocabulary(jnp.asarray(descs), k=k,
                                              iters=iters, seed=seed))
    got = bow.kmedians(torch.from_numpy(descs), torch.from_numpy(descs[init]),
                       iters)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_train_vocabulary_is_seeded_and_shaped():
    rng = np.random.default_rng(6)
    descs = torch.from_numpy(rng.integers(0, 256, (300, 32), dtype=np.uint8))
    v1 = bow.train_vocabulary(descs, k=16, iters=2,
                              generator=torch.Generator().manual_seed(3))
    v2 = bow.train_vocabulary(descs, k=16, iters=2,
                              generator=torch.Generator().manual_seed(3))
    assert v1.shape == (16, 32) and v1.dtype == torch.uint8
    assert torch.equal(v1, v2)


def test_wrappers_refuse_other_devices():
    a = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.hamming_argmin(a, a)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dev_mod.resolve_device(None)
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
