"""`models/refine.py` of the port against the JAX package's, on the same
numpy-seeded images and masks (NHWC there, NCHW here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import refine as JR
from representationlearning_tpu_torch.models import refine as TR
from representationlearning_tpu_torch.ops import affinity as TA
from representationlearning_tpu_torch.ops import neighbors as TN

torch.set_num_threads(2)

# the JAX package's bound for the fused refine against its XLA composition
# (tests/test_pallas_attention.py:299): affinity rounding carried through the
# propagation iterations
TOL = dict(atol=1e-4, rtol=1e-4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    imgs = (rng.random((2, 24, 20, 3)) * 255.0).astype(np.float32)
    masks = rng.random((2, 24, 20, 5)).astype(np.float32)
    low = rng.random((2, 12, 10, 5)).astype(np.float32)  # masks below the image resolution
    return imgs, masks, low


@pytest.mark.parametrize("which", ["same", "low"])
@pytest.mark.parametrize("name,kw", [("varm_refine", dict(w2=0.01)),
                                     ("par_refine", dict(w1=0.3, w2=0.01)),
                                     ("pamr_refine", dict(w1=0.3))])
def test_refine_matches_jax(data, name, kw, which):
    imgs, masks, low = data
    m = masks if which == "same" else low
    dil = (1, 2, 4)
    want = getattr(JR, name)(jnp.asarray(imgs), jnp.asarray(m), dilations=dil, num_iter=4, **kw)
    got = getattr(TR, name)(_nchw(imgs), _nchw(m), dilations=dil, num_iter=4, **kw)
    assert got.shape == (2, 5, 24, 20)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_refine_default_dilations_match_jax(data):
    imgs, _, low = data
    want = JR.varm_refine(jnp.asarray(imgs), jnp.asarray(low), num_iter=2)
    got = TR.varm_refine(_nchw(imgs), _nchw(low), num_iter=2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm,extra,clamp,w2", [
    ("std", "none", False, 0.01), ("w1", "none", False, 0.01), ("bare", "none", False, 0.01),
    ("std", "pos", False, 0.01), ("std", "+var", False, 1.0), ("std", "+var", False, 0.01),
    ("std", "-var", False, 0.01), ("std", "/var", False, 0.01), ("std", "-var", True, 2.0)])
def test_par_variant_matches_jax(data, norm, extra, clamp, w2):
    imgs, _, low = data
    if extra == "/var":
        # in [0, 1] the local variation stays small enough for its softmax, the
        # divisor of the ratio form, not to underflow to 0
        imgs = imgs / 255.0
    kw = dict(dilations=(1, 2), num_iter=3, w1=0.3, w2=w2, norm=norm, extra=extra, clamp=clamp)
    want = np.asarray(JR.par_variant_refine(jnp.asarray(imgs), jnp.asarray(low), **kw))
    got = _nhwc(TR.par_variant_refine(_nchw(imgs), _nchw(low), **kw))
    # the ratio form's weights do not sum to 1, so its masks grow with every
    # iteration: the same relative bound, on the result's own scale
    atol = TOL["atol"] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=TOL["rtol"])


def test_stencil_constants_match_jax():
    assert TN.OFFSETS == JR._OFFSETS
    np.testing.assert_array_equal(TN.DIST, JR._DIST)
    # PAR's position softmax: one implementation in the port (`ops/affinity.py`),
    # held to the JAX module's `_pos_tensor` composition
    pos = JR._pos_tensor((1, 2, 4))
    want = jax.nn.softmax(-((pos / (jnp.std(pos, ddof=1) + 1e-8)) / 0.3) ** 2)
    np.testing.assert_allclose(np.asarray(TA._pos_softmax((1, 2, 4), 0.3)), np.asarray(want),
                               atol=1e-7, rtol=1e-5)
    x = np.random.default_rng(0).random((1, 6, 7, 2)).astype(np.float32)
    want = np.asarray(JR.dilated_neighbors(jnp.asarray(x), (1, 3)))        # (B, H, W, K, C)
    got = TR.dilated_neighbors(_nchw(x), (1, 3)).numpy()                   # (B, K, C, H, W)
    np.testing.assert_array_equal(got.transpose(0, 3, 4, 1, 2), want)
