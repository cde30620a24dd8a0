"""Test-time augmentation and single-device sliding-window inference of the
PyTorch port against the JAX package, on the same numpy-seeded inputs (JAX NHWC
and (H, W, C); the port NCHW and (C, H, W))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from representationlearning_tpu.infer import sliding as JS
from representationlearning_tpu.infer import tta as JT
from representationlearning_tpu_torch.infer import sliding as TS
from representationlearning_tpu_torch.infer import tta as TT

torch.set_num_threads(2)

PAIRS = [("Identity", ()), ("Rotate90k", (1,)), ("Rotate90k", (2,)), ("Rotate90k", (3,)),
         ("HorizontalFlip", ()), ("VerticalFlip", ()), ("Transpose", ())]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name,args", PAIRS)
def test_tta_transforms_match_jax_and_invert_exactly(name, args):
    x = np.random.default_rng(0).random((2, 12, 10, 3)).astype(np.float32)
    jt, tt = getattr(JT, name)(*args), getattr(TT, name)(*args)
    fwd = tt.transform(_nchw(x))
    np.testing.assert_array_equal(_nhwc(fwd), np.asarray(jt.transform(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(tt.inv_transform(fwd)), x)


@pytest.mark.parametrize("sf", [0.5, 0.75, 1.25, 2.0])
def test_tta_scale_matches_jax(sf):
    x = np.random.default_rng(1).random((1, 16, 12, 3)).astype(np.float32)
    jt, tt = JT.Scale(scale_factor=sf), TT.Scale(scale_factor=sf)
    fwd = tt.transform(_nchw(x))
    jf = jt.transform(jnp.asarray(x))
    assert tuple(fwd.shape[-2:]) == jf.shape[1:3] == (int(16 * sf), int(12 * sf))
    # bilinear taps computed in f32 on both sides
    np.testing.assert_allclose(_nhwc(fwd), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(_nhwc(tt.inv_transform(fwd)), np.asarray(jt.inv_transform(jf)),
                               atol=1e-5)


def test_tta_average_matches_jax():
    """A model that is not equivariant (a weight that grows along the rows and,
    half as fast, along the columns), so every transform contributes something
    different."""
    x = np.random.default_rng(2).random((1, 8, 8, 3)).astype(np.float32)
    for jcfg, tcfg in ((JT.full_tta_config(), TT.full_tta_config()),
                       (JT.default_tta_config((0.5, 1.0, 1.5)),
                        TT.default_tta_config((0.5, 1.0, 1.5)))):
        assert [type(t).__name__ for t in jcfg] == [type(t).__name__ for t in tcfg]

        def jfn(v):
            H, W = v.shape[1:3]
            w = jnp.arange(H)[:, None] / H + 0.5 * jnp.arange(W)[None, :] / W
            return v * w[None, :, :, None]

        def tfn(v):
            H, W = v.shape[-2:]
            return v * (torch.arange(H)[:, None] / H + 0.5 * torch.arange(W)[None, :] / W)

        want = np.asarray(JT.tta(jfn, jnp.asarray(x), jcfg))
        got = _nhwc(TT.tta(tfn, _nchw(x), tcfg))
        np.testing.assert_allclose(got, want, atol=1e-5)
    out = TT.tta(lambda v: v, _nchw(x), TT.full_tta_config())
    np.testing.assert_allclose(_nhwc(out), x, atol=1e-6)


def _models(n_out, window, seed):
    """The same window model on both sides: a 3x3 mean filter mixed into n_out
    channels, plus a term that depends on the position inside the window."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((3, n_out)).astype(np.float32)
    pos = rng.standard_normal((window, window, n_out)).astype(np.float32)
    k = np.ones((3, 3, 3, 3), np.float32) * np.eye(3, dtype=np.float32)[None, None] / 9.0

    def jfn(tiles):  # (N, w, w, 3)
        h = jax.lax.conv_general_dilated(tiles, jnp.asarray(k), (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return h @ jnp.asarray(mix) + jnp.asarray(pos)

    def tfn(tiles):  # (N, 3, w, w)
        h = F.conv2d(tiles, torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), padding=1)
        out = torch.einsum("nchw,co->nohw", h, torch.from_numpy(mix))
        return out + torch.from_numpy(pos.transpose(2, 0, 1).copy())

    return jfn, tfn


@pytest.mark.parametrize("H,W,window,stride", [(64, 48, 16, 8), (64, 48, 16, 16), (72, 48, 24, 8),
                                               (70, 33, 16, 8), (10, 40, 16, 8)])
def test_sliding_window_predict_matches_jax(H, W, window, stride):
    """Even and ragged sizes (rows no multiple of the stride, columns not covered
    by whole windows, an image smaller than one window)."""
    n_out = 4
    img = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    jfn, tfn = _models(n_out, window, seed=H)
    want = np.asarray(JS.sliding_window_predict(jfn, jnp.asarray(img), window, stride, n_out))
    got = TS.sliding_window_predict(tfn, torch.from_numpy(img.transpose(2, 0, 1).copy()),
                                    window, stride, n_out)
    assert got.shape == (n_out, H, W) and got.dtype == torch.float32
    # sums of at most (window / stride)^2 window outputs in another order
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, atol=1e-5)


@pytest.mark.parametrize("row_multiple", [1, 3])
def test_pad_for_sliding_matches_jax(row_multiple):
    for H, W in [(70, 33), (100, 16), (64, 40), (5, 5)]:
        img = np.random.default_rng(H).random((H, W, 3)).astype(np.float32)
        jp, jhw = JS.pad_for_sliding(jnp.asarray(img), 16, 8, row_multiple)
        tp, thw = TS.pad_for_sliding(torch.from_numpy(img.transpose(2, 0, 1).copy()), 16, 8,
                                     row_multiple)
        assert thw == jhw == (H, W)
        np.testing.assert_array_equal(tp.numpy().transpose(1, 2, 0), np.asarray(jp))


def test_accumulate_windows_counts_every_cover():
    x = torch.zeros(3, 32, 24)
    acc, cnt = TS._accumulate_windows(lambda t: torch.ones(t.shape[0], 2, 16, 16), x, 16, 8, 2,
                                      range(0, 17, 8))
    assert acc.shape == (2, 32, 24) and cnt.shape == (1, 32, 24)
    assert torch.equal(acc[0:1], cnt) and cnt.min() == 1 and cnt.max() == 4
