"""`wsss/camutils.py` and the new image ops of the port against the JAX package,
function by function, on the same numpy-seeded inputs (NHWC there, NCHW here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.refine import varm_refine as j_varm_refine
from representationlearning_tpu.ops import image as JI
from representationlearning_tpu.wsss import camutils as JCU
from representationlearning_tpu_torch.models.refine import varm_refine
from representationlearning_tpu_torch.ops import image as TI
from representationlearning_tpu_torch.wsss import camutils as CU

torch.set_num_threads(2)

ATOL = 1e-5  # float outputs: the same f32 arithmetic, sums in another order


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _j_cam_fn(inputs):
    """Stand-in for model(cam_only=True), as in tests/test_camutils.py."""
    x = JI.resize_bilinear(inputs, (inputs.shape[1] // 4, inputs.shape[2] // 4))
    cam = jnp.stack([x[..., 0] - x[..., 1], x[..., 1] * 0.5, x[..., 2] - 0.2], axis=-1)
    B, h, w, _ = cam.shape
    return cam, jnp.full((B, h * w, h * w), float(h))


def _t_cam_fn(inputs):
    x = TI.resize_bilinear(inputs, (inputs.shape[2] // 4, inputs.shape[3] // 4))
    cam = torch.stack([x[:, 0] - x[:, 1], x[:, 1] * 0.5, x[:, 2] - 0.2], dim=1)
    B, _, h, w = cam.shape
    return cam, torch.full((B, h * w, h * w), float(h))


# ------------------------------------------------------------------ image ops
@pytest.mark.parametrize("size", [(4, 4), (7, 5), (32, 48), (16, 24)])
def test_resize_nearest_matches_jax(size):
    x = np.random.default_rng(0).random((2, 16, 24, 3)).astype(np.float32)
    got = TI.resize_nearest(_nchw(x), size)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(JI.resize_nearest(jnp.asarray(x), size)))
    torch_own = torch.nn.functional.interpolate(_nchw(x), size=size, mode="nearest")
    assert torch.equal(got, torch_own)


def test_interpolate_flip_and_minmax_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 12, 10, 4)).astype(np.float32)
    jx, tx = jnp.asarray(x), _nchw(x)
    np.testing.assert_array_equal(_nhwc(TI.flip_lr(tx)), np.asarray(JI.flip_lr(jx)))
    np.testing.assert_allclose(_nhwc(TI.minmax_normalize_cam(tx)),
                               np.asarray(JI.minmax_normalize_cam(jx)), atol=1e-6)
    for kw in (dict(scale_factor=0.5), dict(size=(9, 7), align_corners=True),
               dict(scale_factor=(2, 1.5), mode="nearest")):
        np.testing.assert_allclose(_nhwc(TI.interpolate(tx, **kw)),
                                   np.asarray(JI.interpolate(jx, **kw)), atol=ATOL)
    with pytest.raises(ValueError, match="unsupported mode"):
        TI.interpolate(tx, size=(3, 3), mode="bicubic")


# ------------------------------------------------------------------ CAMs
@pytest.mark.parametrize("scales", [(1.0, 0.5, 1.5), (1.0,), (0.5, 1.0)])
def test_multi_scale_cam_matches_jax(scales):
    x = np.random.default_rng(2).random((2, 32, 40, 3)).astype(np.float32)
    j_cam, j_ref = JCU.multi_scale_cam_with_ref_mat(_j_cam_fn, jnp.asarray(x), scales)
    cam, ref = CU.multi_scale_cam_with_ref_mat(_t_cam_fn, _nchw(x), scales)
    assert cam.shape == (2, 3, 32, 40)
    np.testing.assert_allclose(_nhwc(cam), np.asarray(j_cam), atol=ATOL)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(j_ref))  # the same scale's ref
    np.testing.assert_allclose(_nhwc(CU.multi_scale_cam(_t_cam_fn, _nchw(x), scales)),
                               np.asarray(JCU.multi_scale_cam(_j_cam_fn, jnp.asarray(x), scales)),
                               atol=ATOL)


@pytest.mark.parametrize("ignore_mid", [False, True])
def test_cam_to_label_matches_jax(ignore_mid):
    rng = np.random.default_rng(3)
    cam = rng.random((3, 12, 10, 4)).astype(np.float32)
    cls = np.array([[1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0]], np.float32)
    box = np.array([[1, 11, 1, 9], [0, 12, 0, 10], [3, 8, 2, 10]])
    j_valid, j_lab = JCU.cam_to_label(jnp.asarray(cam), jnp.asarray(cls), jnp.asarray(box),
                                      ignore_mid=ignore_mid)
    valid, lab = CU.cam_to_label(_nchw(cam), torch.from_numpy(cls), torch.from_numpy(box),
                                 ignore_mid=ignore_mid)
    np.testing.assert_array_equal(_nhwc(valid), np.asarray(j_valid))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(
        CU.cam_to_label(_nchw(cam), torch.from_numpy(cls)).numpy(),
        np.asarray(JCU.cam_to_label(jnp.asarray(cam), jnp.asarray(cls))))
    lab0 = torch.from_numpy(rng.integers(0, 5, (3, 12, 10)))
    np.testing.assert_array_equal(
        CU.ignore_outside_box(lab0, torch.from_numpy(box)).numpy(),
        np.asarray(JCU.ignore_outside_box(jnp.asarray(lab0.numpy()), jnp.asarray(box))))


def _refine_inputs():
    rng = np.random.default_rng(7)
    B, H, W, Cf = 3, 16, 16, 8
    imgs = rng.random((B, H, W, 3)).astype(np.float32) * 255
    cams = rng.random((B, H, W, Cf)).astype(np.float32)
    cls = np.zeros((B, Cf), np.float32)
    cls[0, [1, 4]] = 1
    cls[1, [0, 2, 7]] = 1
    cls[2, [5]] = 1
    box = np.array([[0, H, 0, W], [2, 14, 2, 14], [0, H, 4, W]])
    return imgs, cams, cls, box


def _close_calls(j_refine, imgs, cams, cls, box, down_scale=2):
    """Pixels where the JAX side's top-two refined probabilities, in either
    threshold stack, lie within 1e-3: only there may an argmax differ."""
    B, H, W, Cf = cams.shape
    seen = {}

    def spy(im, m):
        seen["out"] = j_refine(im, m)
        return seen["out"]

    JCU.refine_cams_with_bkg_v2(spy, jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(cls),
                                jnp.asarray(box), down_scale=down_scale)
    both = np.asarray(JI.resize_bilinear(seen["out"], (H, W)))
    valid = np.concatenate([np.ones((B, 1)), cls], 1)[:, None, None, :] > 0
    close = np.zeros((B, H, W), bool)
    for stack in (both[..., :Cf + 1], both[..., Cf + 1:]):
        top = np.sort(np.where(valid, stack, -np.inf), axis=-1)
        close |= (top[..., -1] - top[..., -2]) < 1e-3
    return close


@pytest.mark.parametrize("max_present", [None, 3, 4, 8])
def test_refine_cams_with_bkg_v2_matches_jax(max_present):
    imgs, cams, cls, box = _refine_inputs()
    j_refine = lambda im, m: j_varm_refine(im, m, dilations=(1, 2), num_iter=2)  # noqa: E731
    t_refine = lambda im, m: varm_refine(im, m, dilations=(1, 2), num_iter=2)    # noqa: E731
    want = np.asarray(JCU.refine_cams_with_bkg_v2(
        j_refine, jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(cls), jnp.asarray(box),
        max_present=max_present))
    got = CU.refine_cams_with_bkg_v2(
        t_refine, _nchw(imgs), _nchw(cams), torch.from_numpy(cls), torch.from_numpy(box),
        max_present=max_present).numpy()
    assert got.shape == want.shape == (3, 16, 16)
    differ = got != want
    close = _close_calls(j_refine, imgs, cams, cls, box)
    assert not (differ & ~close).any(), "labels differ away from a near-tie"
    print(f"refined labels that differ (all at near-ties): {int(differ.sum())} of {differ.size}")
    assert differ.sum() == 0  # none at this size
    # the compact gather equals the port's own full path
    full = CU.refine_cams_with_bkg_v2(t_refine, _nchw(imgs), _nchw(cams), torch.from_numpy(cls),
                                      torch.from_numpy(box)).numpy()
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cams_to_refine_label_and_resized_match_jax(with_mask):
    rng = np.random.default_rng(2)
    lab = rng.integers(0, 3, (2, 32, 48)).astype(np.int64)
    lab[0, :8] = 255
    N = 2 * 3
    mask = (rng.random((N, N)) > 0.3).astype(np.float32) if with_mask else None
    got = CU.cams_to_refine_label(torch.from_numpy(lab),
                                  None if mask is None else torch.from_numpy(mask))
    want = JCU.cams_to_refine_label(jnp.asarray(lab), None if mask is None else jnp.asarray(mask))
    assert got.shape == (2, N, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    size_mask = (rng.random((20, 30)) > 0.3).astype(np.float32) if with_mask else None
    got = CU.cams_to_label_resized(
        torch.from_numpy(lab), None if size_mask is None else torch.from_numpy(size_mask),
        size=(20, 30))
    want = JCU.cams_to_label_resized(
        jnp.asarray(lab), None if size_mask is None else jnp.asarray(size_mask), size=(20, 30))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_mask", [False, True])
def test_propagate_ref_cam_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    B, h, w, Cf = 2, 4, 5, 3
    N = h * w
    cams = rng.random((B, h, w, Cf)).astype(np.float32)
    ref = rng.random((B, N, N)).astype(np.float32)
    cls = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    mask = JCU.get_mask_by_radius(h, w, 2) if with_mask else None
    j_mask = None if mask is None else jnp.asarray(mask)
    t_mask = None if mask is None else torch.from_numpy(mask)
    want = JCU.propagate_ref_cam_with_bkg(jnp.asarray(cams), jnp.asarray(ref), jnp.asarray(cls),
                                          bkg_score=0.45, mask=j_mask)
    got = CU.propagate_ref_cam_with_bkg(_nchw(cams), torch.from_numpy(ref),
                                        torch.from_numpy(cls), bkg_score=0.45, mask=t_mask)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    want = JCU.propagate_ref_cam(jnp.asarray(cams), jnp.asarray(ref), mask=j_mask)
    got = CU.propagate_ref_cam(_nchw(cams), torch.from_numpy(ref), mask=t_mask)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("h,w,r", [(5, 5, 2), (4, 7, 8), (20, 20, 8)])
def test_get_mask_by_radius_matches_jax(h, w, r):
    np.testing.assert_array_equal(CU.get_mask_by_radius(h, w, r), JCU.get_mask_by_radius(h, w, r))
