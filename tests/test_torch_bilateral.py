"""`ops/bilateral.py` of the PyTorch port against the JAX package: features, the
exact transform, the bilateral grid (also in a batch), and the grid against the
exact transform on a tiny image, as tests/test_bilateral_energy.py does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.ops import bilateral as JB
from representationlearning_tpu_torch.ops import bilateral as TB

torch.set_num_threads(2)


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _data(seed, H=12, W=10, K=3, N=None):
    rng = np.random.default_rng(seed)
    lead = () if N is None else (N,)
    img = (rng.random(lead + (H, W, 3)) * 255).astype(np.float32)
    x = rng.random(lead + (H, W, K)).astype(np.float32)
    return img, x


def test_features_match_jax():
    img, _ = _data(0)
    want = np.asarray(JB._features(jnp.asarray(img), 15.0, 50.0))
    got = TB._features(_chw(img), 15.0, 50.0)
    assert got.shape == (12, 10, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_brute_matches_jax():
    img, x = _data(1)
    want = np.asarray(JB.bilateral_filter_brute(jnp.asarray(img), jnp.asarray(x), 15.0, 5.0))
    got = TB.bilateral_filter_brute(_chw(img), _chw(x), 15.0, 5.0)
    # f32 sums of 120 terms in another order, exp within a few ulp
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigmas", [(15.0, 5.0), (40.0, 3.0), (15.0, 50.0)])
def test_grid_matches_jax(sigmas):
    srgb, sxy = sigmas
    img, x = _data(2)
    want = np.asarray(JB.bilateral_filter_grid(jnp.asarray(img), jnp.asarray(x), srgb, sxy))
    got = TB.bilateral_filter_grid(_chw(img), _chw(x), srgb, sxy)
    assert got.shape == (3, 12, 10)
    # the same splat, taps and slice; the scatter adds in another order
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_batch_matches_jax_and_the_single_image_call(method):
    img, x = _data(3, N=3)
    want = np.asarray(JB.bilateral_filter_batch(jnp.asarray(img), jnp.asarray(x), 15.0, 5.0,
                                                method=method))
    got = TB.bilateral_filter_batch(_chw(img), _chw(x), 15.0, 5.0, method=method)
    assert got.shape == (3, 3, 12, 10)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-5)
    if method == "grid":  # the slabs of the batched grid do not leak into each other
        one = TB.bilateral_filter_grid(_chw(img)[1], _chw(x)[1], 15.0, 5.0)
        np.testing.assert_allclose(got[1].numpy(), one.numpy(), rtol=1e-5, atol=1e-6)


def test_grid_approximates_the_exact_transform():
    """The bound tests/test_bilateral_energy.py holds the JAX grid to."""
    rng = np.random.default_rng(4)
    base = rng.random((3, 3, 3)).astype(np.float32)
    img = np.kron(base, np.ones((6, 6, 1), np.float32)) * 255.0  # smooth blocks
    x = rng.random((18, 18, 2)).astype(np.float32)
    exact = TB.bilateral_filter_brute(_chw(img), _chw(x), 30.0, 6.0)
    grid = TB.bilateral_filter_grid(_chw(img), _chw(x), 30.0, 6.0)
    rel = ((grid - exact).norm() / exact.norm()).item()
    j_exact = np.asarray(JB.bilateral_filter_brute(jnp.asarray(img), jnp.asarray(x), 30.0, 6.0))
    j_grid = np.asarray(JB.bilateral_filter_grid(jnp.asarray(img), jnp.asarray(x), 30.0, 6.0))
    j_rel = np.linalg.norm(j_grid - j_exact) / np.linalg.norm(j_exact)
    assert rel < 0.25 and abs(rel - j_rel) < 1e-3, (rel, j_rel)


def test_native_names_what_is_missing_and_unknown_methods_raise():
    """`native` is the port's own build of the host lattice (it raised before the
    lattice was ported): the JAX package's native result on the same arrays; an
    unknown method raises."""
    img, x = _data(5, N=1)
    want = np.asarray(JB.bilateral_filter_batch(jnp.asarray(img), jnp.asarray(x), 15.0, 5.0,
                                                method="native"))
    got = TB.bilateral_filter_batch(_chw(img), _chw(x), 15.0, 5.0, method="native")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown bilateral method"):
        TB.bilateral_filter_batch(_chw(img), _chw(x), 15.0, 5.0, method="lattice")
    # the train step's grid: 160 x 160 at sigma_xy 50, sigma_rgb 15
    assert TB._grid_dims(160, 160, 15.0, 50.0, 255.0) == (9, 9, 22, 22, 22)
