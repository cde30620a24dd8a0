"""The LoveDA half of the port's on-device augmentation (`data/device_transforms.py`:
`augment_loveda_batch`, `sample_loveda_decisions`, `LoveDAAugConfig`,
`_affine_reflect_warp`, `_reflect101`, `_one_of_flip_rot`) against the JAX
package's, with the same decisions drawn by numpy and handed to both sides, as
`tests/test_device_transforms.py:241-376` drives the JAX chain: every flip / rot90
op and k, with and without ShiftScaleRotate, an identity warp, and sampled
batches. Images within 1e-4; masks equal, except where a nearest tap's source
coordinate lies within 1e-4 of a half, where the last bit of the two libraries'
sin and cos decides the tap (such pixels are counted, and must be few)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data import device_transforms as JD
from representationlearning_tpu_torch.data import device_transforms as TD

torch.set_num_threads(2)

NEAR_HALF = 1e-4


def _u(k, n):
    """u01 such that floor(u * n) == k."""
    return (k + 0.5) / n


def _sample(seed, sizes, classes=3):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    masks = []
    for h, w in sizes:
        m = rng.integers(0, classes, (h, w)).astype(np.int32)
        m[:3] = -1        # a band of ignore, as LoveDA's mask - 1 gives
        m[h // 2:, : w // 2] = 1
        masks.append(m)
    return imgs, masks


def _decisions(B, tries=10, **over):
    d = {"pad_u": np.zeros((B, 2), np.float32), "crop_u": np.zeros((B, tries, 2), np.float32),
         "fr_on": np.zeros(B, bool), "op": np.zeros(B, np.int32), "rot_k": np.ones(B, np.int32),
         "ssr_on": np.zeros(B, bool), "angle": np.zeros(B, np.float32),
         "ssr_scale": np.ones(B, np.float32), "shift": np.zeros((B, 2), np.float32)}
    d.update({k: np.asarray(v, d[k].dtype).reshape(d[k].shape) for k, v in over.items()})
    return d


def _both(imgs, masks, d, crop, S, classes=3):
    """The JAX chain (jitted, as its CLI runs it) and the port's on the same
    canvases and decisions: (port image NCHW, port mask, JAX image NCHW, JAX mask)."""
    canvas, hw, lab = JD.pad_to_canvas(imgs, S, masks, ignore_index=-1)
    jcfg = JD.LoveDAAugConfig(crop_size=crop, num_classes=classes)
    want_img, want_lab = jax.jit(lambda i, h, m, dd: JD.augment_loveda_batch(i, h, m, dd, jcfg))(
        jnp.asarray(canvas), jnp.asarray(hw), jnp.asarray(lab),
        {k: jnp.asarray(v) for k, v in d.items()})
    t_canvas, t_hw, t_lab = TD.pad_to_canvas(imgs, S, masks, ignore_index=-1)
    got_img, got_lab = TD.augment_loveda_batch(t_canvas, t_hw, t_lab,
                                               {k: torch.from_numpy(v) for k, v in d.items()},
                                               TD.LoveDAAugConfig(*jcfg))
    assert got_img.dtype == torch.float32 and got_lab.dtype == torch.int32
    assert got_img.shape == (len(imgs), 3, crop, crop) and got_lab.shape == (len(imgs), crop, crop)
    return (got_img.numpy(), got_lab.numpy(), np.asarray(want_img).transpose(0, 3, 1, 2),
            np.asarray(want_lab))


def _near_half(d, crop):
    """Pixels whose ShiftScaleRotate source coordinate lies within NEAR_HALF of a
    half, in the samples that warp."""
    sx, sy = TD._affine_source_coords(crop, crop, torch.from_numpy(d["angle"]),
                                      torch.from_numpy(d["ssr_scale"]),
                                      torch.from_numpy(d["shift"]))
    near = torch.zeros_like(sx, dtype=torch.bool)
    for s in (sx, sy):
        near |= ((s - torch.floor(s)) - 0.5).abs() < NEAR_HALF
    return near.numpy() & d["ssr_on"][:, None, None]


def _check(got_img, got_lab, want_img, want_lab, d, crop, atol=1e-4):
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=atol)
    near = _near_half(d, crop)
    far = ~near
    np.testing.assert_array_equal(got_lab[far], want_lab[far])
    assert near.mean() < 0.01, near.mean()
    return int((got_lab[near] != want_lab[near]).sum())


@pytest.mark.parametrize("op,k", [(0, 1), (1, 1), (2, 1), (2, 2), (2, 3)])
@pytest.mark.parametrize("ssr", [False, True])
def test_crop_fliprot_and_ssr_match_jax(op, k, ssr):
    imgs, masks = _sample(5, [(40, 40), (37, 45)])
    crop, S = 32, 48
    d = _decisions(2, fr_on=[True, True], op=[op, op], rot_k=[k, k], ssr_on=[ssr, ssr],
                   angle=[17.0, -38.5], ssr_scale=[1.1, 0.83], shift=[[0.03, -0.02], [-0.06, 0.05]],
                   crop_u=np.stack([np.full((10, 2), _u(5, 9)), np.full((10, 2), _u(2, 14))]))
    got_img, got_lab, want_img, want_lab = _both(imgs, masks, d, crop, S)
    _check(got_img, got_lab, want_img, want_lab, d, crop)
    if not ssr:   # no resampling: the crop and the flip / rotation move pixels exactly
        np.testing.assert_array_equal(got_lab, want_lab)


def test_identity_ssr_is_a_noop_and_matches_jax():
    imgs, masks = _sample(7, [(40, 40)])
    crop, S = 32, 48
    base = _decisions(1, crop_u=np.full((1, 10, 2), _u(4, 9)))
    warp = _decisions(1, crop_u=np.full((1, 10, 2), _u(4, 9)), ssr_on=[True])
    a_img, a_lab, want_a, want_a_lab = _both(imgs, masks, base, crop, S)
    b_img, b_lab, want_b, want_b_lab = _both(imgs, masks, warp, crop, S)
    np.testing.assert_array_equal(a_lab, b_lab)
    np.testing.assert_array_equal(b_lab, want_b_lab)
    np.testing.assert_allclose(a_img, b_img, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b_img, want_b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(a_img, want_a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,S,crop", [(8, 48, 32), (9, 72, 40), (10, 64, 64)])
def test_sampled_batches_match_jax(seed, S, crop):
    """numpy-drawn decisions over every branch, images larger and smaller than the
    crop (padded with 0 and the ignore index), the crop retry over ten tries."""
    rng = np.random.default_rng(seed)
    B = 8
    sizes = [(int(rng.integers(crop // 2, S + 1)), int(rng.integers(crop // 2, S + 1)))
             for _ in range(B)]
    imgs, masks = _sample(seed, sizes)
    d = _decisions(B, pad_u=rng.random((B, 2)), crop_u=rng.random((B, 10, 2)),
                   fr_on=rng.random(B) < 0.75, op=rng.integers(0, 3, B),
                   rot_k=rng.integers(1, 4, B), ssr_on=rng.random(B) < 0.5,
                   angle=rng.uniform(-45, 45, B), ssr_scale=1 + rng.uniform(-0.2, 0.2, B),
                   shift=rng.uniform(-0.0625, 0.0625, (B, 2)))
    got_img, got_lab, want_img, want_lab = _both(imgs, masks, d, crop, S)
    flipped = _check(got_img, got_lab, want_img, want_lab, d, crop)
    assert flipped <= 4
    assert set(np.unique(got_lab).tolist()) <= {-1, 0, 1, 2}


def test_affine_reflect_warp_matches_jax():
    """The warp alone, both samplers, at angles up to 45 degrees and scales that
    read well past the border (reflected)."""
    rng = np.random.default_rng(12)
    B, C, H, W = 4, 2, 24, 24
    img = rng.random((B, H, W, C)).astype(np.float32) * 9
    ang = np.array([45.0, -30.0, 5.5, 0.0], np.float32)
    sc = np.array([0.8, 1.2, 0.95, 1.0], np.float32)
    sh = np.array([[0.06, 0.0], [-0.05, 0.04], [0.0, -0.06], [0.0, 0.0]], np.float32)
    for nearest in (False, True):
        got = TD._affine_reflect_warp(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                      torch.from_numpy(ang), torch.from_numpy(sc),
                                      torch.from_numpy(sh), nearest).numpy()
        want = np.stack([np.asarray(JD._affine_reflect_warp(
            jnp.asarray(img[b]), jnp.asarray(ang[b]), jnp.asarray(sc[b]), jnp.asarray(sh[b]),
            nearest)) for b in range(B)]).transpose(0, 3, 1, 2)
        if nearest:
            d = {"angle": ang, "ssr_scale": sc, "shift": sh, "ssr_on": np.ones(B, bool)}
            far = ~np.broadcast_to(_near_half(d, H)[:, None], got.shape)
            np.testing.assert_array_equal(got[far], want[far])
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_reflect101_and_one_of_flip_rot_match_jax():
    i = torch.arange(-40, 41)
    for n in (1, 2, 5, 16):
        np.testing.assert_array_equal(TD._reflect101(i, n).numpy(),
                                      np.asarray(JD._reflect101(jnp.asarray(i.numpy()), n)))
    rng = np.random.default_rng(13)
    x = rng.random((5, 6, 6, 2)).astype(np.float32)
    m = rng.integers(0, 4, (5, 6, 6, 1)).astype(np.float32)
    on = np.array([True, True, True, True, False])
    op, k = np.array([0, 1, 2, 2, 2], np.int32), np.array([1, 3, 1, 3, 2], np.int32)
    gi, gm = TD._one_of_flip_rot(*(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in (x, m)),
                                 torch.from_numpy(on), torch.from_numpy(op), torch.from_numpy(k))
    for b in range(5):
        wi, wm = JD._one_of_flip_rot(jnp.asarray(x[b]), jnp.asarray(m[b]), on[b], op[b], k[b])
        np.testing.assert_array_equal(gi[b].numpy(), np.asarray(wi).transpose(2, 0, 1))
        np.testing.assert_array_equal(gm[b].numpy(), np.asarray(wm).transpose(2, 0, 1))


def test_loveda_config_has_the_jax_fields_and_defaults():
    assert TD.LoveDAAugConfig._fields == JD.LoveDAAugConfig._fields
    assert TD.LoveDAAugConfig._field_defaults == JD.LoveDAAugConfig._field_defaults


def test_sample_loveda_decisions_has_the_jax_keys_shapes_and_ranges():
    cfg = TD.LoveDAAugConfig(crop_size=32, crop_tries=6)
    B = 4000
    got = TD.sample_loveda_decisions(B, cfg, torch.Generator().manual_seed(0))
    want = JD.sample_loveda_decisions(jax.random.PRNGKey(0), B, JD.LoveDAAugConfig(*cfg))
    assert set(got) == set(want) and len(got) == 9
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].is_floating_point() == jnp.issubdtype(v.dtype, jnp.floating), k
        assert (got[k].dtype == torch.bool) == (v.dtype == jnp.bool_), k
    again = TD.sample_loveda_decisions(B, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert set(got["op"].tolist()) == {0, 1, 2} and set(got["rot_k"].tolist()) == {1, 2, 3}
    assert 0.72 < got["fr_on"].float().mean() < 0.78 and 0.17 < got["ssr_on"].float().mean() < 0.23
    for k, (lo, hi) in {"angle": (-45, 45), "ssr_scale": (0.8, 1.2),
                        "shift": (-0.0625, 0.0625), "pad_u": (0, 1), "crop_u": (0, 1)}.items():
        assert lo <= got[k].min() and got[k].max() < hi, k
        assert got[k].max() - got[k].min() > 0.95 * (hi - lo), k
    imgs, masks = _sample(14, [(40, 30)] * 4)
    canvas, hw, lab = TD.pad_to_canvas(imgs, 48, masks, ignore_index=-1)
    dec = TD.sample_loveda_decisions(4, cfg, torch.Generator().manual_seed(1))
    out, m = TD.augment_loveda_batch(canvas, hw, lab, dec, cfg._replace(num_classes=3))
    assert torch.isfinite(out).all() and set(m.unique().tolist()) <= {-1, 0, 1, 2}
