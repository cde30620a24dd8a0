"""The segmentation half of the port's on-device augmentation
(`data/device_transforms.py`: `augment_seg_batch`, `_pick_crop_try`,
`photometric_distort`, `pad_to_canvas(labels=)`, `sample_seg_decisions`) against
the JAX package's, with the same decisions drawn by numpy and handed to both
sides: labels and `img_box` equal; images within 1e-4 without the photometric
step and, with it, by the JAX package's own rule for its device chain against the
host (`tests/test_device_transforms.py:186-192`): at most 2.1 uint8 steps, under
2% of the pixels beyond 1.05 (the chain floors to uint8 values after every step,
so a last-bit difference of two libraries' f32 arithmetic on a value that lands on
an integer moves it by one step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data import device_transforms as JD
from representationlearning_tpu_torch.data import device_transforms as TD

torch.set_num_threads(2)

STEP = 57.0   # about one uint8 step of a normalised pixel (IMAGENET_STD ~ 57)


def _labels(rng, h, w, classes):
    """Bands of classes with an ignore strip and a blob: some windows hold one
    class, some several."""
    lab = np.zeros((h, w), np.int32)
    lab[h // 2:] = 1 % classes
    lab[:, : w // 3] = 2 % classes
    cy, cx = rng.integers(0, h), rng.integers(0, w)
    ys, xs = np.ogrid[:h, :w]
    lab[(ys - cy) ** 2 + (xs - cx) ** 2 <= (min(h, w) // 4) ** 2] = classes - 1
    lab[:2] = 255
    return lab


def _sample(rng, sizes, S, classes):
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    labs = [_labels(rng, h, w, classes) for h, w in sizes]
    return imgs, labs, JD.pad_to_canvas(imgs, S, labs)


def _decisions(rng, B, tries, photometric: bool, flip=None):
    on = (lambda: rng.random(B) < 0.7) if photometric else (lambda: np.zeros(B, bool))
    return {"scale": np.ones(B, np.float32),
            "flip": rng.random(B) < 0.5 if flip is None else np.full(B, flip),
            "pad_u": rng.random((B, 2)).astype(np.float32),
            "crop_u": rng.random((B, tries, 2)).astype(np.float32),
            "bright_on": on(), "bright_delta": rng.uniform(-32, 32, B).astype(np.float32),
            "mode": (rng.random(B) < 0.5).astype(np.int32),
            "contrast_on": on(), "contrast_alpha": rng.uniform(0.5, 1.5, B).astype(np.float32),
            "sat_on": on(), "sat_alpha": rng.uniform(0.5, 1.5, B).astype(np.float32),
            "hue_on": on(), "hue_delta": rng.integers(-18, 18, B).astype(np.float32)}


def _photometric_close(got, want):
    """The JAX package's rule for a chain with the photometric step, in uint8 steps."""
    diff = np.abs(got - want)
    assert diff.max() <= 2.1, diff.max()
    assert (diff > 1.05).mean() < 0.02, (diff > 1.05).mean()


@pytest.mark.parametrize("S,sizes,crop,classes,photometric,ratio", [
    (48, [(30, 26), (48, 40), (20, 33)], 24, 3, False, 0.75),     # larger and smaller than the crop
    (48, [(30, 26), (48, 40), (20, 33)], 24, 3, True, 0.75),      # the photometric step on
    (64, [(64, 64), (40, 57), (17, 63), (50, 50)], 32, 5, True, 0.5),
    (40, [(40, 40), (33, 21)], 32, 3, False, 0.0),                # no retry: the first try
    (96, [(96, 80), (71, 96)], 64, 21, True, 0.75),               # VOC's class count
])
def test_augment_seg_batch_matches_jax(S, sizes, crop, classes, photometric, ratio):
    rng = np.random.default_rng(S + crop + classes)
    B = len(sizes)
    imgs, labs, (canvas, hw, lab) = _sample(rng, sizes, S, classes)
    d = _decisions(rng, B, 10, photometric)
    jcfg = JD.DeviceAugConfig(crop_size=crop, scale_range=None, photometric=photometric,
                              cat_max_ratio=ratio, num_classes=classes)
    want_img, want_lab, want_box = jax.jit(lambda i, h, l, dd: JD.augment_seg_batch(
        i, h, l, dd, jcfg))(jnp.asarray(canvas), jnp.asarray(hw), jnp.asarray(lab),
                            {k: jnp.asarray(v) for k, v in d.items()})
    t_canvas, t_hw, t_lab = TD.pad_to_canvas(imgs, S, labs)
    got_img, got_lab, got_box = TD.augment_seg_batch(
        t_canvas, t_hw, t_lab, {k: torch.from_numpy(v) for k, v in d.items()},
        TD.DeviceAugConfig(*jcfg))
    assert got_img.shape == (B, 3, crop, crop) and got_img.dtype == torch.float32
    assert got_lab.dtype == torch.int32 and got_box.dtype == torch.int32
    np.testing.assert_array_equal(got_box.numpy(), np.asarray(want_box))
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    want = np.asarray(want_img).transpose(0, 3, 1, 2)
    if photometric:
        _photometric_close(got_img.numpy() * STEP, want * STEP)
    else:
        np.testing.assert_allclose(got_img.numpy(), want, rtol=0, atol=1e-4)


def _jax_pick(lab, h, w, sh, sw, pad, offs, flip, cfg):
    return np.stack([np.asarray(JD._pick_crop_try(
        jnp.asarray(lab[b]), jnp.asarray(h[b]), jnp.asarray(w[b]), jnp.asarray(sh[b]),
        jnp.asarray(sw[b]), jnp.asarray(pad[b]), jnp.asarray(offs[b]), jnp.asarray(flip[b]),
        cfg)) for b in range(len(h))])


def test_pick_crop_try_picks_the_jax_try():
    """Sample 0: the first try passes (the host stops there, `:195` of the JAX
    test); sample 1: at ratio 0.6 only the fourth passes; sample 2: none passes,
    so the last try; samples 3 and 4: the same tries, flipped and not, where only
    the flipped window passes."""
    h, w, crop, K = 30, 26, 24, 10
    lab = np.zeros((h, w), np.int32)
    lab[: h // 2], lab[h // 2:] = 1, 2
    one_class = np.full((h, w), 1, np.int32)
    left = np.where(np.arange(w)[None] < 8, 0, 1) * np.ones((h, 1), np.int32)
    labs = np.stack([lab, lab, one_class, left, left])
    side = [(0, 2)] * 9 + [(5, 0)]
    tries = np.array([[(3, 1)] + [(0, 0)] * 9, [(6, 0)] * 3 + [(3, 1)] + [(6, 0)] * 6,
                      [(k % 7, k % 3) for k in range(K)], side, side], np.int32)
    B = len(labs)
    hw = np.array([[h, w]] * B, np.int32)
    pad = np.zeros((B, 2), np.int32)
    flip = np.array([False, False, False, True, False])
    picks = {}
    for ratio in (0.75, 0.6, 0.3):
        jcfg = JD.DeviceAugConfig(crop_size=crop, num_classes=3, cat_max_ratio=ratio)
        want = _jax_pick(labs, hw[:, 0], hw[:, 1], hw[:, 0], hw[:, 1], pad, tries, flip, jcfg)
        got = TD._pick_crop_try(*(torch.from_numpy(np.array(a)) for a in (
            labs, hw[:, 0], hw[:, 1], hw[:, 0], hw[:, 1], pad, tries, flip)),
            TD.DeviceAugConfig(*jcfg))
        np.testing.assert_array_equal(got.numpy(), want)
        picks[ratio] = [tuple(p) for p in want.tolist()]
    assert picks[0.75][0] == (3, 1) and picks[0.6][1] == (3, 1)
    assert picks[0.75][2] == (2, 0) and picks[0.75][3:] == [(0, 2), (5, 0)]


def test_pick_crop_try_matches_jax_on_random_windows():
    rng = np.random.default_rng(11)
    B, S, crop, K = 6, 40, 24, 10
    sizes = [(int(rng.integers(18, 41)), int(rng.integers(18, 41))) for _ in range(B)]
    _, labs, (_, hw, lab) = _sample(rng, sizes, S, 4)
    d = _decisions(rng, B, K, False)
    sh, sw, pad, offs = (np.asarray(a) for a in JD._geometry(
        jnp.asarray(hw), jnp.ones((B,)), jnp.asarray(d["pad_u"]), jnp.asarray(d["crop_u"]), crop))
    jcfg = JD.DeviceAugConfig(crop_size=crop, num_classes=4)
    want = _jax_pick(lab, hw[:, 0], hw[:, 1], sh, sw, pad, offs, d["flip"], jcfg)
    got = TD._pick_crop_try(*(torch.from_numpy(np.array(a)) for a in (
        lab, hw[:, 0], hw[:, 1], sh, sw, pad, offs, d["flip"])), TD.DeviceAugConfig(*jcfg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_to_canvas_with_labels_matches_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((20, 30), (40, 12), (9, 9))]
    labs = [rng.integers(0, 7, i.shape[:2]).astype(np.int64) for i in imgs]
    for ignore in (255, -1):
        want = JD.pad_to_canvas(imgs, 32, labs, ignore_index=ignore)
        got = TD.pad_to_canvas(imgs, 32, labs, ignore_index=ignore)
        assert len(got) == 3 and got[2].dtype == torch.int32 and got[0].dtype == torch.uint8
        np.testing.assert_array_equal(got[0].numpy(), want[0].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert len(TD.pad_to_canvas(imgs, 32)) == 2   # the image-only call of the WSSS chains


def test_photometric_distort_matches_jax():
    """Each gate alone and all together, both modes, on the whole canvas."""
    rng = np.random.default_rng(5)
    B, H, W = 8, 20, 24
    img = rng.integers(0, 256, (B, H, W, 3)).astype(np.float32)
    d = _decisions(rng, B, 1, True)
    gates = ("bright_on", "contrast_on", "sat_on", "hue_on")
    for b in range(4):   # samples 0-3: one gate each; 4-7 all on
        for g in gates:
            d[g][b] = g == gates[b]
        for g in gates:
            d[g][b + 4] = True
    d["mode"][:] = [0, 1, 0, 1, 0, 1, 0, 1]
    got = TD.photometric_distort(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                 {k: torch.from_numpy(v) for k, v in d.items()})
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    want = np.stack([np.asarray(JD.photometric_distort(jnp.asarray(img[b]), jd, b, None))
                     for b in range(B)]).transpose(0, 3, 1, 2)
    _photometric_close(got.numpy(), want)
    assert (got.numpy() == np.floor(got.numpy())).all() and got.min() >= 0 and got.max() <= 255


def test_hsv_conversions_match_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.float32)
    img[0, :4] = img[0, :4, :, :1]              # grey pixels: delta 0
    t = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    hsv = TD._rgb_to_hsv_cv_j(t)
    want = np.asarray(JD._rgb_to_hsv_cv_j(jnp.asarray(img))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(hsv.numpy(), want, rtol=0, atol=1e-3)
    back = TD._hsv_to_rgb_cv_j(torch.from_numpy(want.copy()))
    want_back = np.asarray(JD._hsv_to_rgb_cv_j(jnp.asarray(want.transpose(0, 2, 3, 1))))
    _photometric_close(back.numpy(), want_back.transpose(0, 3, 1, 2))


def test_sample_seg_decisions_has_the_jax_keys_shapes_and_ranges():
    cfg = TD.DeviceAugConfig(crop_size=32, brightness_delta=20.0, contrast_range=(0.6, 1.2),
                             saturation_range=(0.7, 1.3), hue_delta=9)
    B = 4000
    got = TD.sample_seg_decisions(B, cfg, torch.Generator().manual_seed(0))
    want = JD.sample_seg_decisions(jax.random.PRNGKey(0), B, JD.DeviceAugConfig(*cfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].is_floating_point() == jnp.issubdtype(v.dtype, jnp.floating), k
        assert (got[k].dtype == torch.bool) == (v.dtype == jnp.bool_), k
    again = TD.sample_seg_decisions(B, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert torch.equal(got["scale"], torch.ones(B))
    for k, (lo, hi) in {"bright_delta": (-20, 20), "contrast_alpha": (0.6, 1.2),
                        "sat_alpha": (0.7, 1.3)}.items():
        assert lo <= got[k].min() and got[k].max() < hi and got[k].max() - got[k].min() > 0.9 * (hi - lo)
    assert set(got["hue_delta"].tolist()) == set(range(-9, 9))
    assert set(got["mode"].tolist()) == {0, 1}
    for k in ("bright_on", "contrast_on", "sat_on", "hue_on", "flip"):
        assert 0.45 < got[k].float().mean() < 0.55
    canvas, hw, lab = TD.pad_to_canvas([np.full((40, 30, 3), 90, np.uint8)] * 3, 48,
                                       [np.arange(1200).reshape(40, 30) % 3] * 3)
    dec = TD.sample_seg_decisions(3, TD.DeviceAugConfig(crop_size=32, num_classes=3),
                                  torch.Generator().manual_seed(1))
    img, lab_c, box = TD.augment_seg_batch(canvas, hw, lab, dec,
                                           TD.DeviceAugConfig(crop_size=32, num_classes=3))
    assert torch.isfinite(img).all() and lab_c.shape == (3, 32, 32)
    assert set(lab_c.unique().tolist()) <= {0, 1, 2, 255}
