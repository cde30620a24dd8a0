"""DenseCRF of the PyTorch port (`ops/crf.py`), its host lattice (`native/`) and
`wsss/camutils.py::cam_to_fg_bg_label` against the JAX package: mean-field Q with
the bilateral grid and the exact transform within 1e-4, the wrappers, the port's
own build of the permutohedral lattice against JAX's on the same arrays, the
grid-versus-lattice label agreement JAX's test asserts, and the confident fg / bg
labels equal except at near-ties. Images (3, H, W) in [0, 255]."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu import native as jnative
from representationlearning_tpu.ops import bilateral as JB
from representationlearning_tpu.ops import crf as JC
from representationlearning_tpu.wsss import camutils as JCU
from representationlearning_tpu_torch import native as tnative
from representationlearning_tpu_torch.ops import bilateral as TB
from representationlearning_tpu_torch.ops import crf as TC
from representationlearning_tpu_torch.wsss import camutils as TCU

torch.set_num_threads(2)

Q_TOL = 1e-4      # probabilities after ten f32 mean-field rounds, sums in another order
NATIVE_TOL = 1e-6  # one source, two builds: equal, or this close where the flags differ
NEAR = 1e-3       # a label may differ only where JAX's two best scores are this close


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _scene(seed, H=64, W=96, k=3):
    """CAM-like synthetic scene, as tests/test_indexing_crf.py draws it: discs of
    flat colour plus noise, their labels, and labels with 8% noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W, 3), np.float32)
    lab = np.zeros((H, W), np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    for c in range(1, k + 1):
        cy, cx = rng.integers(10, H - 10), rng.integers(10, W - 10)
        r = rng.integers(8, 20)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        lab[m] = c
        img[m] = rng.random(3) * 200 + 30
    img += rng.normal(0, 12, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.float32)
    noisy = np.where(rng.random((H, W)) < 0.08, rng.integers(0, k + 1, (H, W)), lab)
    return img, lab, noisy.astype(np.int32)


def _softmax_probs(seed, C, H, W):
    logits = np.random.default_rng(seed).standard_normal((C, H, W)).astype(np.float32) * 2
    e = np.exp(logits - logits.max(0))
    return (e / e.sum(0)).astype(np.float32)


@pytest.mark.parametrize("method,H,W", [("grid", 24, 32), ("brute", 10, 12)])
def test_mean_field_matches_jax(method, H, W):
    img = (np.random.default_rng(0).random((H, W, 3)) * 255).astype(np.float32)
    probs = _softmax_probs(1, 4, H, W)
    u = np.asarray(JC.unary_from_softmax(jnp.asarray(probs.transpose(1, 2, 0))))
    want = np.asarray(JC.mean_field_inference(jnp.asarray(img), jnp.asarray(u), t=5,
                                              sxy_b=20.0, method=method))
    got = TC.mean_field_inference(_chw(img), TC.unary_from_softmax(torch.from_numpy(probs)),
                                  t=5, sxy_b=20.0, method=method)
    assert got.shape == (4, H, W)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=0, atol=Q_TOL)


def test_gaussian_blur_and_unaries_match_jax():
    x = np.random.default_rng(2).random((7, 12, 3)).astype(np.float32)
    for sigma in (0.5, 3.0):   # radius 2, and radius 9: inside W, beyond H
        want = np.asarray(JC._gaussian_blur_2d(jnp.asarray(x), sigma))
        got = TC._gaussian_blur_2d(_chw(x), sigma)
        np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=1e-6, atol=1e-6)
    lab = np.random.default_rng(3).integers(0, 5, (6, 8))
    want = np.asarray(JC.unary_from_labels(jnp.asarray(lab), 5, 0.7))
    got = TC.unary_from_labels(torch.from_numpy(lab), 5, 0.7)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=1e-6)


def test_crf_inference_and_dense_crf_match_jax():
    img, _, _ = _scene(4, 32, 40, k=2)
    probs = _softmax_probs(5, 3, 32, 40)
    want = JC.crf_inference(img, probs, t=4)
    got = TC.crf_inference(_chw(img), torch.from_numpy(probs), t=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=Q_TOL)
    args = (4, 3.0, 3.0, 5.0, 60.0, 10.0)
    want = JC.DenseCRF(*args)(img, probs)
    got = TC.DenseCRF(*args)(_chw(img), torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=Q_TOL)


def _label_near_ties(img, labels, n_labels, method="grid"):
    """Where JAX's `crf_inference_label` has its two best Q within NEAR: its own
    mean-field call, with the same arguments (so the same compiled function)."""
    u = JC.unary_from_labels(jnp.asarray(labels), n_labels, 0.7)
    q = JC.mean_field_inference(jnp.asarray(img, jnp.float32), u, t=10, sxy_g=3.0,
                                compat_g=3.0, sxy_b=50.0, srgb_b=5.0, compat_b=10.0,
                                method=method)
    s = np.sort(np.asarray(q), axis=-1)
    return np.asarray(q).argmax(-1), (s[..., -1] - s[..., -2]) < NEAR


def test_crf_inference_label_matches_jax():
    """Labels equal except where JAX's two best Q are within NEAR. JAX's labels are
    the argmax of its mean-field call with `crf_inference_label`'s arguments,
    which is what that function returns."""
    img, _, noisy = _scene(6)
    want, near = _label_near_ties(img, noisy, 4)
    got = TC.crf_inference_label(_chw(img), torch.from_numpy(noisy), t=10, n_labels=4)
    assert got.dtype == torch.int64 and got.shape == (64, 96)
    assert not ((got.numpy() != want) & ~near).any()


def test_native_lattice_equals_jax_build():
    """The port's copy of permutohedral.cc, built into the port's _build/, against
    the JAX package's build on the same arrays."""
    assert tnative.SRC.read_bytes() == (
        tnative.SRC.parents[2] / "representationlearning_tpu/native/permutohedral.cc").read_bytes()
    path = tnative.library_path()
    assert path.parent.parent == tnative.BUILD_DIR
    rng = np.random.default_rng(7)
    imgs = (rng.random((2, 20, 24, 3)) * 255).astype(np.float32)
    x = rng.random((2, 20, 24, 3)).astype(np.float32)
    want = jnative.bilateral_filter_batch_native(imgs, x, 13.0, 8.0)
    got = tnative.bilateral_filter_batch_native(imgs, x, 13.0, 8.0)
    assert path.exists()
    np.testing.assert_allclose(got, want, rtol=NATIVE_TOL, atol=NATIVE_TOL)
    one = tnative.bilateral_filter_native(imgs[1], x[1], 13.0, 8.0)
    np.testing.assert_allclose(one, want[1], rtol=NATIVE_TOL, atol=NATIVE_TOL)


def test_failed_lattice_build_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to the grid."""
    bad = tmp_path / "permutohedral.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TB.bilateral_filter_batch(torch.zeros(1, 3, 4, 4), torch.zeros(1, 2, 4, 4), 5.0, 3.0,
                                  method="native")


def test_bilateral_native_matches_jax():
    """`bilateral_filter_batch(method="native")`: NCHW in and out, the lattice's
    own amplitude (about LATTICE_GAIN_5D times the exact sum)."""
    rng = np.random.default_rng(8)
    imgs = (rng.random((2, 16, 20, 3)) * 255).astype(np.float32)
    x = rng.random((2, 16, 20, 4)).astype(np.float32)
    want = np.asarray(JB.bilateral_filter_batch(jnp.asarray(imgs), jnp.asarray(x), 13.0, 8.0,
                                                method="native"))
    got = TB.bilateral_filter_batch(_chw(imgs), _chw(x), 13.0, 8.0, method="native")
    assert got.shape == (2, 4, 16, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=NATIVE_TOL,
                               atol=NATIVE_TOL)
    exact = TB.bilateral_filter_brute(_chw(imgs[0]), _chw(x[0]), 13.0, 8.0)
    gain = (got[0] * exact).sum() / (exact * exact).sum()
    assert abs(gain.item() / TB.LATTICE_GAIN_5D - 1) < 0.1


def test_crf_label_grid_vs_native():
    """The bilateral grid against the exact lattice through `crf_inference_label`:
    above 99% of the labels agree, the bound of
    tests/test_indexing_crf.py::test_crf_label_grid_vs_native."""
    img, _, noisy = _scene(0)
    g = TC.crf_inference_label(_chw(img), torch.from_numpy(noisy), t=10, n_labels=4,
                               method="grid")
    n = TC.crf_inference_label(_chw(img), torch.from_numpy(noisy), t=10, n_labels=4,
                               method="native")
    assert (g == n).float().mean().item() > 0.99
    want = JC.crf_inference_label(img, noisy, t=10, n_labels=4, method="native")
    assert (n.numpy() == want).mean() > 0.999


def test_cam_to_fg_bg_label_matches_jax():
    """Two images with three present classes each: the confident labels equal
    JAX's except where a CRF pass of JAX's has its two best Q within NEAR. Both
    take the host lattice (`crf_method="native"`), which costs a fraction of the
    grid's 57^3 colour cells on the CPU; the grid's labels are held to JAX's by
    test_crf_inference_label_matches_jax."""
    rng = np.random.default_rng(9)
    B, H, W, C = 2, 64, 96, 20
    img, _, _ = _scene(10, H, W)
    images = np.stack([img, img[:, ::-1]]).astype(np.float32)
    mean, std = np.array([123.675, 116.28, 103.53]), np.array([58.395, 57.12, 57.375])
    norm = ((images - mean) / std).astype(np.float32)
    cams = rng.random((B, H // 4, W // 4, C)).astype(np.float32) * 0.5
    cls = np.zeros((B, C), np.float32)
    cls[0, [4, 9, 15]] = cls[1, [2, 11, 19]] = 1.0
    cams[0, 2:9, 3:12, 4] = 0.9
    cams[1, 6:14, 1:10, 11] = 0.8
    want = np.asarray(JCU.cam_to_fg_bg_label(jnp.asarray(norm), jnp.asarray(cams),
                                             jnp.asarray(cls), crf_method="native"))
    got = TCU.cam_to_fg_bg_label(_chw(norm), _chw(cams), torch.from_numpy(cls),
                                 crf_method="native")
    assert got.shape == (B, H, W) and got.dtype == torch.float32
    assert {0.0, 1.0} < set(np.unique(want))

    up = np.asarray(JCU.resize_bilinear_auto(jnp.asarray(cams), (H, W)))
    near = np.zeros((B, H, W), bool)
    for i in range(B):
        keys = np.nonzero(np.concatenate([[1.0], cls[i]]))[0]
        valid = up[i].transpose(2, 0, 1)[keys[1:] - 1]
        for thre in (0.3, 0.6):
            padded = np.concatenate([np.full((1, H, W), thre), valid], 0)
            near[i] |= _label_near_ties(images[i], np.argmax(padded, 0), len(keys), "native")[1]
    assert not ((got.numpy() != want) & ~near).any()
