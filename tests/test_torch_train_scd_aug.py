"""The SCD train step with on-device augmentation (`make_scd_train_step(aug_cfg=)`)
against the JAX command line's fused step (`cli/train_scd.py:171-190`: decisions,
`augment_cls_batch`, then the losses), on the smallest MiT (`mit_b0`), raw uint8
canvases of 160² cropped to 128², f32, batch 2, the CAMs through the fused twin.
Both sides take the same numpy-drawn decisions and the same correlation
coordinates, and both run the model without dropout and drop-path (the two
libraries' draws cannot agree; training-mode behaviour is held module by module in
tests/test_torch_train_mode.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data import device_transforms as JD
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.train import scd as JS
from representationlearning_tpu_torch.convert.from_jax import tscd_state_dict_from_jax
from representationlearning_tpu_torch.data import device_transforms as TD
from representationlearning_tpu_torch.models.tscd import TSCD, share_parameters
from representationlearning_tpu_torch.train import optim as TO
from representationlearning_tpu_torch.train import scd as TS
from representationlearning_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

KW = dict(num_classes=21, crop_size=128, cam_scales=(1.0,), varm_dilations=(1, 2, 4),
          varm_iters=4, max_present=4, corr_samples=12, cam_iters=-1, energy_weight=1e-4)
LOSSES = ("cls", "seg", "energy", "aux", "corr", "er")
S, CROP = 160, 128


def _canvases(rng):
    """Two images with coarse structure (so the CAMs' labels have no broad
    near-ties), placed on 160² canvases as the host collation does."""
    imgs = []
    for h, w in ((150, 120), (96, 160)):
        coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w] + rng.integers(-20, 21, (h, w, 3))
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(11)
    imgs = _canvases(rng)
    canvas, hw = JD.pad_to_canvas(imgs, S)
    dec = {"scale": np.array([0.8, 1.45], np.float32), "flip": np.array([True, False]),
           "pad_u": rng.random((2, 2)).astype(np.float32),
           "crop_u": rng.random((2, 10, 2)).astype(np.float32)}
    cls = np.zeros((2, 20), np.float32)
    cls[0, [2, 14]] = 1
    cls[1, [5]] = 1

    # JAX: the command line's fused step up to the losses, its decisions given
    jcfg = JD.DeviceAugConfig(crop_size=CROP, scale_range=(0.5, 2.0), num_classes=21)
    image, box = JD.augment_cls_batch(jnp.asarray(canvas), jnp.asarray(hw),
                                      {k: jnp.asarray(v) for k, v in dec.items()}, jcfg)
    model = JTSCD(backbone="mit_b0", num_classes=21)
    twin = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True, collect_attns="none")
    v = jax.jit(model.init)(jax.random.PRNGKey(1), image[:1])
    cfg = JS.SCDConfig(**KW)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def losses_fn(v, image, box):
        batch = {"image": image, "img_box": box, "cls_label": jnp.asarray(cls)}
        losses, _ = JS.scd_losses(v, model.apply, batch, key, cfg, JS._attn_mask(cfg),
                                  train=False, cam_apply_fn=twin.apply)
        return losses, JS.scd_total_loss(losses, jnp.asarray(0), cfg)

    losses, total = losses_fn(v, image, box)
    want = dict(image=np.asarray(image).transpose(0, 3, 1, 2), box=np.asarray(box),
                total=float(total), losses={k: float(losses[k]) for k in LOSSES})

    # the port: the raw batch through make_scd_train_step(aug_cfg=), the same
    # decisions and coordinates handed in where the step would draw its own
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    m = TSCD("mit_b0", 21, device="cpu")
    m.load_state_dict(tscd_state_dict_from_jax(to_np(v)))
    t_twin = share_parameters(
        TSCD("mit_b0", 21, fused_blocks=True, collect_attns="none", device="cpu"), m).eval()
    k1, k2 = jax.random.split(jax.random.split(key)[1])   # scd.py:74, wsss.py:95
    coords = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (2, 12, 12, 2)) * 2.0 - 1.0))
                   for k in (k1, k2))
    seen = {}
    orig_losses, orig_sample = TS.scd_losses, TD.sample_cls_decisions

    def given_decisions(batch, cfg, generator=None, device="cpu"):
        seen["decisions_for"] = batch
        return {k: torch.from_numpy(v).to(device) for k, v in dec.items()}

    def losses_in_eval(model, batch, cfg, attn_mask=None, generator=None, cam_model=None,
                       coords=None):
        seen["batch"] = batch
        model.eval()   # the step put it in training mode: no dropout or drop-path here
        return orig_losses(model, batch, cfg, attn_mask, generator=generator,
                           cam_model=cam_model, coords=coords_given)

    coords_given = coords
    t_canvas, t_hw = TD.pad_to_canvas(imgs, S)
    raw = {"raw": t_canvas, "hw": t_hw, "cls_label": torch.from_numpy(cls)}
    t_cfg = TS.SCDConfig(**KW)
    state = TrainState.create(m, TO.make_poly_warmup_adamw(
        m, 6e-5, 0.01, 0, 100, param_labels=TO.tscd_param_labels))
    step = TS.make_scd_train_step(m, t_cfg, cam_model=t_twin, device="cpu",
                                  aug_cfg=TD.DeviceAugConfig(crop_size=CROP,
                                                             scale_range=(0.5, 2.0)))
    TS.scd_losses, TD.sample_cls_decisions = losses_in_eval, given_decisions
    try:
        state, metrics = step(state, raw, torch.Generator().manual_seed(0))
    finally:
        TS.scd_losses, TD.sample_cls_decisions = orig_losses, orig_sample
    got = dict(batch=seen["batch"], decisions_for=seen["decisions_for"], state=state,
               total=float(metrics["total"]), losses={k: float(metrics[k]) for k in LOSSES})
    return want, got


def test_the_step_augments_the_raw_batch_as_jax_does(both):
    want, got = both
    assert got["decisions_for"] == 2
    assert set(got["batch"]) == {"image", "img_box", "cls_label"}
    image = got["batch"]["image"]
    assert image.shape == (2, 3, CROP, CROP) and image.dtype == torch.float32
    # the bound of tests/test_torch_device_transforms.py's chain
    np.testing.assert_allclose(image.numpy(), want["image"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["batch"]["img_box"].numpy(), want["box"])


@pytest.mark.parametrize("name", LOSSES)
def test_each_loss_of_the_augmenting_step_matches_jax(both, name):
    want, got = both
    print(name, got["losses"][name], want["losses"][name])
    # the bound of tests/test_torch_train_scd.py: f32 end to end, a label that differs
    # at a near-tie moves the label-driven losses by its share of the pixels
    np.testing.assert_allclose(got["losses"][name], want["losses"][name], rtol=2e-3, atol=1e-6)
    if name in ("seg", "energy", "aux", "corr", "cls"):
        assert abs(got["losses"][name]) > 1e-6   # the comparison is not of zeros


def test_total_of_the_augmenting_step_matches_jax(both):
    want, got = both
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-4)
    assert got["state"].step == 1
