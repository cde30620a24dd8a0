"""The classification half of the port's on-device augmentation
(`data/device_transforms.py`) against the JAX package's, with the same decisions
drawn by numpy and handed to both sides: images within 1e-4, `img_box` equal, at
a few canvas and image sizes, down- and up-scales, flips and crop placements.
Also `pad_to_canvas`, the nearest warp, and the sampled decisions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data import device_transforms as JD
from representationlearning_tpu_torch.data import device_transforms as TD

torch.set_num_threads(2)


def _raw(rng, B, S, sizes):
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes[:B]]
    return imgs, JD.pad_to_canvas(imgs, S)


def _decisions(rng, B, tries, scale, flip):
    return {"scale": np.full((B,), scale, np.float32) if scale is not None else
            rng.uniform(0.5, 2.0, B).astype(np.float32),
            "flip": np.array([flip if flip is not None else bool(b % 2) for b in range(B)]),
            "pad_u": rng.random((B, 2)).astype(np.float32),
            "crop_u": rng.random((B, tries, 2)).astype(np.float32)}


@pytest.mark.parametrize("S,sizes,crop,scale,flip", [
    (512, [(375, 500), (500, 333), (200, 300)], 320, None, None),   # bench-like, jittered
    (512, [(375, 500), (375, 500)], 320, 0.5, True),                  # smaller than the crop
    (512, [(375, 500), (281, 417)], 320, 1.9, False),                 # much larger than it
    (96, [(96, 80), (50, 96), (33, 41)], 64, 1.0, None),              # scale 1, odd sizes
    (64, [(64, 64), (17, 63)], 48, 0.73, True),
])
def test_augment_cls_batch_matches_jax(S, sizes, crop, scale, flip):
    rng = np.random.default_rng(S + crop)
    B = len(sizes)
    _, (canvas, hw) = _raw(rng, B, S, sizes)
    d = _decisions(rng, B, 10, scale, flip)
    jcfg = JD.DeviceAugConfig(crop_size=crop, scale_range=(0.5, 2.0))
    want_img, want_box = JD.augment_cls_batch(jnp.asarray(canvas), jnp.asarray(hw),
                                              {k: jnp.asarray(v) for k, v in d.items()}, jcfg)
    t_canvas, t_hw = TD.pad_to_canvas([canvas[b, :h, :w] for b, (h, w) in enumerate(hw)], S)
    got_img, got_box = TD.augment_cls_batch(t_canvas, t_hw,
                                            {k: torch.from_numpy(v) for k, v in d.items()},
                                            TD.DeviceAugConfig(crop_size=crop))
    assert got_img.shape == (B, 3, crop, crop) and got_img.dtype == torch.float32
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_box.numpy(), np.asarray(want_box))


def test_pad_to_canvas_matches_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((20, 30), (40, 12), (9, 9))]
    want, want_hw = JD.pad_to_canvas(imgs, 32)   # the (40, 12) image is cut to 32 rows
    got, got_hw = TD.pad_to_canvas(imgs, 32)
    assert got.dtype == torch.uint8 and got_hw.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got_hw.numpy(), want_hw)


@pytest.mark.parametrize("nearest", [False, True])
def test_warp_one_matches_jax(nearest):
    """The warp alone, both samplers, against the JAX ``_warp_one`` of each sample."""
    rng = np.random.default_rng(4)
    img = rng.random((2, 40, 40, 2)).astype(np.float32) * 9
    h, w = np.array([40, 31]), np.array([37, 40])
    sh, sw = np.array([55, 20]), np.array([50, 29])
    pad, off = np.array([[3, 0], [5, 7]]), np.array([[10, 2], [0, 1]])
    flip = np.array([True, False])
    got = TD._warp_one(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                       *(torch.from_numpy(a) for a in (h, w, sh, sw, pad, off, flip)),
                       24, (7.0, -1.0), nearest)
    for b in range(2):
        want = JD._warp_one(jnp.asarray(img[b]), jnp.asarray(h[b]), jnp.asarray(w[b]),
                            jnp.asarray(sh[b]), jnp.asarray(sw[b]), jnp.asarray(pad[b]),
                            jnp.asarray(off[b]), jnp.asarray(flip[b]), 24, (7.0, -1.0), nearest)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want).transpose(2, 0, 1),
                                   rtol=0, atol=1e-5)


def test_sampled_decisions_and_their_batch():
    """Draws from a seed repeat; their ranges are those of the JAX draws; a sampled
    batch is finite with a box inside the crop."""
    cfg = TD.DeviceAugConfig(crop_size=64, scale_range=(0.5, 2.0))
    a = TD.sample_cls_decisions(6, cfg, torch.Generator().manual_seed(1))
    b = TD.sample_cls_decisions(6, cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["crop_u"].shape == (6, 10, 2) and a["flip"].dtype == torch.bool
    assert ((a["scale"] >= 0.5) & (a["scale"] < 2.0)).all()
    canvas, hw = TD.pad_to_canvas([np.full((50, 60, 3), 128, np.uint8)] * 6, 96)
    img, box = TD.augment_cls_batch(canvas, hw, a, cfg)
    assert torch.isfinite(img).all() and img.shape == (6, 3, 64, 64)
    assert ((box >= 0) & (box <= 64)).all() and (box[:, 0] <= box[:, 1]).all()


def test_augment_raw_batch_is_the_sampled_chain():
    """The train steps' raw batch -> the losses' batch: decisions from the
    generator, then the chain; cls_label passed through."""
    cfg = TD.DeviceAugConfig(crop_size=48, scale_range=(0.7, 1.4))
    canvas, hw = TD.pad_to_canvas([np.random.default_rng(i).integers(0, 256, (40 + i, 56, 3))
                                   .astype(np.uint8) for i in range(3)], 64)
    cls = torch.eye(20)[:3]
    got = TD.augment_raw_batch({"raw": canvas, "hw": hw, "cls_label": cls}, cfg,
                               torch.Generator().manual_seed(4))
    dec = TD.sample_cls_decisions(3, cfg, torch.Generator().manual_seed(4))
    img, box = TD.augment_cls_batch(canvas, hw, dec, cfg)
    assert set(got) == {"image", "img_box", "cls_label"} and got["cls_label"] is cls
    assert torch.equal(got["image"], img) and torch.equal(got["img_box"], box)


def test_device_aug_config_has_the_jax_fields_and_defaults():
    """The port's config holds the JAX package's fields in its order with its
    defaults, so the JAX callers' keywords construct it (`bench.py:427-428`,
    `cli/train_rml.py:114-119`); the classification chain reads only crop_size,
    scale_range, crop_tries and mean_rgb, so the other fields change no decision
    and no image."""
    assert TD.DeviceAugConfig._fields == JD.DeviceAugConfig._fields
    assert TD.DeviceAugConfig._field_defaults == JD.DeviceAugConfig._field_defaults
    bench = TD.DeviceAugConfig(crop_size=320, scale_range=(0.5, 2.0), num_classes=21)
    cli = TD.DeviceAugConfig(crop_size=320, scale_range=(0.5, 2.0), num_classes=21,
                             ignore_index=255)
    assert bench == cli == TD.DeviceAugConfig()
    other = TD.DeviceAugConfig(fliplr=False, photometric=True, cat_max_ratio=0.5,
                               num_classes=3, ignore_index=0, brightness_delta=8.0,
                               contrast_range=(0.9, 1.1), saturation_range=(0.9, 1.1),
                               hue_delta=2)
    a = TD.sample_cls_decisions(4, TD.DeviceAugConfig(), torch.Generator().manual_seed(5))
    b = TD.sample_cls_decisions(4, other, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a) and a["crop_u"].shape == (4, 10, 2)
    rng = np.random.default_rng(6)
    _, (canvas, hw) = _raw(rng, 4, 512, [(375, 500)] * 4)
    t_canvas, t_hw = torch.from_numpy(canvas.transpose(0, 3, 1, 2).copy()), torch.from_numpy(hw)
    img, box = TD.augment_cls_batch(t_canvas, t_hw, a, TD.DeviceAugConfig())
    img_o, box_o = TD.augment_cls_batch(t_canvas, t_hw, b, other)
    assert torch.equal(img, img_o) and torch.equal(box, box_o)
    want_img, want_box = JD.augment_cls_batch(jnp.asarray(canvas), jnp.asarray(hw),
                                              {k: jnp.asarray(v.numpy()) for k, v in a.items()},
                                              JD.DeviceAugConfig())
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(box.numpy(), np.asarray(want_box))
