"""The host augmentation chain of the PyTorch port (`data/transforms.py`) against the
JAX package's: the same numpy inputs and the same `np.random.Generator` seeds give
equal bits, function by function (tolerance: none)."""
import numpy as np
import pytest

from representationlearning_tpu.data import transforms as JT
from representationlearning_tpu_torch.data import transforms as TT

SEEDS = range(6)


def _image(seed, h=37, w=53):
    return np.random.default_rng(100 + seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _label(seed, h=37, w=53, classes=(0, 3, 7, 255)):
    return np.random.default_rng(200 + seed).choice(classes, (h, w)).astype(np.uint8)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(name, seed, *args, **kw):
    """fn(rng, *args) of both packages from generators of the same seed; the
    generators must also be left in the same state."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(JT, name)(rj, *args, **kw)
    got = getattr(TT, name)(rt, *args, **kw)
    _same(got, want)
    assert rj.random() == rt.random()
    return got


def test_constants_and_normalisation():
    assert TT.IMAGENET_MEAN == JT.IMAGENET_MEAN and TT.IMAGENET_STD == JT.IMAGENET_STD
    img = _image(0).astype(np.float32)
    _same(TT.normalize_img(img), JT.normalize_img(img))
    _same(TT.denormalize_img(img / 50.0), JT.denormalize_img(img / 50.0))
    _same(TT.normalize_img(img, mean=(1, 2, 3), std=(4, 5, 6)),
          JT.normalize_img(img, mean=(1, 2, 3), std=(4, 5, 6)))


@pytest.mark.parametrize("scale", [0.5, 0.73, 1.0, 1.9])
def test_rescale(scale):
    img, lab = _image(1).astype(np.float32), _label(1)
    _same(TT._rescale(img, lab, scale), JT._rescale(img, lab, scale))
    _same(TT._rescale(img, None, scale), JT._rescale(img, None, scale))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_scaling(seed):
    img, lab = _image(seed).astype(np.float32), _label(seed)
    _both("random_scaling", seed, img)
    _both("random_scaling", seed, img, lab, scale_range=(0.7, 1.3))


@pytest.mark.parametrize("hw", [(37, 53), (600, 520), (512, 700)])
def test_img_resize_short(hw):
    img = np.random.default_rng(3).integers(0, 256, hw + (3,)).astype(np.float32)
    _same(TT.img_resize_short(img, 512), JT.img_resize_short(img, 512))
    _same(TT.img_resize_short(img, 64), JT.img_resize_short(img, 64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["random_fliplr", "random_flipud", "random_rot90"])
def test_flips_and_rotation(name, seed):
    img, lab = _image(seed), _label(seed)
    _both(name, seed, img)
    _both(name, seed, img, lab)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hw,crop", [((37, 53), 64), ((96, 128), 64), ((40, 90), 48)])
def test_random_crop(seed, hw, crop):
    img, lab = _image(seed, *hw).astype(np.float32), _label(seed, *hw)
    _both("random_crop", seed, img, None, crop_size=crop, mean_rgb=(0.0, 0.0, 0.0))
    _both("random_crop", seed, img, lab, crop_size=crop, mean_rgb=TT.IMAGENET_MEAN)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_crop_cat_max_ratio_retry(seed):
    """One class covers most of the image, so windows are refused and redrawn
    (up to 10 tries); both packages draw the same windows."""
    lab = np.zeros((90, 90), np.uint8)
    lab[:, :70] = 5
    lab[80:, 80:] = 9
    img = _image(seed, 90, 90).astype(np.float32)
    crop, crop_lab, box = _both("random_crop", seed, img, lab, crop_size=40)
    _both("random_crop", seed, img, lab, crop_size=40, cat_max_ratio=0.99)
    assert crop.shape == (40, 40, 3) and crop_lab.shape == (40, 40) and box.dtype == np.int32


def test_random_crop_redraws_dominated_windows():
    """The retry is reached: with the label, most seeds draw more windows than the
    one a crop without a label takes."""
    lab = np.zeros((90, 90), np.uint8)
    lab[:, :70] = 5
    lab[80:, 80:] = 9
    img = _image(0, 90, 90).astype(np.float32)
    redrawn = 0
    for seed in SEEDS:
        with_label, without = np.random.default_rng(seed), np.random.default_rng(seed)
        TT.random_crop(with_label, img, lab, crop_size=40)
        TT.random_crop(without, img, None, crop_size=40)
        redrawn += with_label.random() != without.random()
    assert redrawn >= len(SEEDS) // 2


def test_img_box_marks_the_real_pixels():
    img = np.full((20, 30, 3), 7.0, np.float32)
    for seed in SEEDS:
        crop, box = TT.random_crop(np.random.default_rng(seed), img, None, crop_size=48)
        _, jbox = JT.random_crop(np.random.default_rng(seed), img, None, crop_size=48)
        _same(box, jbox)
        y0, y1, x0, x1 = box
        assert (y1 - y0, x1 - x0) == (20, 30)
        assert (crop[y0:y1, x0:x1] == 7.0).all() and crop.sum() == 7.0 * 20 * 30 * 3


@pytest.mark.parametrize("seed", SEEDS)
def test_hsv_round_trip(seed):
    img = _image(seed)
    hsv = TT._rgb_to_hsv_cv(img)
    _same(hsv, JT._rgb_to_hsv_cv(img))
    hsv[..., 0] = (hsv[..., 0] + 17) % 180
    _same(TT._hsv_to_rgb_cv(hsv), JT._hsv_to_rgb_cv(hsv))


@pytest.mark.parametrize("seed", range(12))
def test_photometric_distortion(seed):
    """Twelve seeds reach every branch (each op at p = 0.5, contrast first or last)."""
    img = _image(seed)
    kw = dict(brightness_delta=40, contrast_range=(0.6, 1.4), saturation_range=(0.4, 1.6),
              hue_delta=12)
    for make_t, make_j in ((TT.PhotoMetricDistortion, JT.PhotoMetricDistortion),
                           (lambda: TT.PhotoMetricDistortion(**kw),
                            lambda: JT.PhotoMetricDistortion(**kw))):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(make_t()(rt, img), make_j()(rj, img))
        assert rj.random() == rt.random()


@pytest.mark.parametrize("seed", SEEDS)
def test_shift_scale_rotate(seed):
    img, mask = _image(seed).astype(np.float32), _label(seed)
    _both("shift_scale_rotate", seed, img)
    _both("shift_scale_rotate", seed, img, mask, shift_limit=0.1, scale_limit=0.3,
          rotate_limit=30.0)
