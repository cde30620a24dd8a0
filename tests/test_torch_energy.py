"""`losses/energy.py` of the PyTorch port against the JAX package: the value and
the hand-written gradient of the dense energy loss, with the grid and with the
exact filter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.losses import energy as JE
from representationlearning_tpu_torch.losses import energy as TE

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _data(seed=0, B=2, H=16, W=12, C=5):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    logit = rng.standard_normal((B, H, W, C)).astype(np.float32) * 2
    label = rng.choice([0, 1, 3, 255], size=(B, H, W))
    box = np.array([[0, H, 0, W], [2, H - 2, 0, W - 3]])[:B]
    return img, logit, label, box


@pytest.mark.parametrize("method", ["grid", "brute"])
def test_get_energy_loss_value_and_gradient(method):
    img, logit, label, box = _data()
    kw = dict(weight=1e-3, method=method)
    want, wg = jax.value_and_grad(
        lambda l: JE.get_energy_loss(jnp.asarray(img), l, jnp.asarray(label), jnp.asarray(box),
                                     **kw))(jnp.asarray(logit))
    tl = _nchw(logit).requires_grad_()
    got = TE.get_energy_loss(_nchw(img), tl, torch.from_numpy(label), torch.from_numpy(box), **kw)
    assert abs(float(want)) > 1e-4
    # f32; the filter's scatter and the dot product sum in another order
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    g = torch.autograd.grad(got, tl)[0].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(g, np.asarray(wg), rtol=1e-3, atol=1e-7 * np.abs(wg).max() + 1e-9)


def test_dense_energy_gradient_is_the_hand_written_one():
    """grad_seg = -2 g AS / N * roi, and nothing for images, rois and gate
    (`losses.py:86-91`): not what autograd would give through the filter."""
    rng = np.random.default_rng(1)
    img = torch.from_numpy((rng.random((2, 3, 8, 8)) * 255).astype(np.float32)).requires_grad_()
    seg = torch.from_numpy(rng.random((2, 4, 8, 8)).astype(np.float32)).requires_grad_()
    roi = torch.ones(2, 8, 8)
    roi[1, :, 6:] = 0
    roi.requires_grad_()
    gate = torch.from_numpy(rng.random((2, 1, 8, 8)).astype(np.float32)).requires_grad_()
    loss = TE._dense_energy(img, seg, roi, gate, 15.0, 4.0, "brute")
    g_img, g_seg, g_roi, g_gate = torch.autograd.grad(3.0 * loss, (img, seg, roi, gate),
                                                      allow_unused=True)
    assert g_img is None and g_roi is None and g_gate is None
    from representationlearning_tpu_torch.ops.bilateral import bilateral_filter_batch
    with torch.no_grad():
        AS = bilateral_filter_batch(img, seg * roi[:, None], 15.0, 4.0, method="brute") * gate
        np.testing.assert_allclose(float(loss), float(-(seg * roi[:, None] * AS).sum() / 2),
                                   rtol=1e-6)
        want = -2.0 * 3.0 * AS / 2 * roi[:, None]
    np.testing.assert_allclose(g_seg.numpy(), want.numpy(), rtol=1e-6, atol=1e-9)
    assert (g_seg[1, :, :, 6:] == 0).all()


def test_dense_energy_loss_downscales_and_gates_as_jax():
    img, logit, label, _ = _data(2, H=20, W=20)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logit), axis=-1))
    rois = np.ones((2, 20, 20), np.float32)
    rois[0, :5] = 0
    images = (img * 50 + 120).astype(np.float32)
    want = JE.dense_energy_loss(jnp.asarray(images), jnp.asarray(probs), jnp.asarray(rois),
                                jnp.asarray(label), weight=1.0, sigma_xy=20.0)
    got = TE.dense_energy_loss(_nchw(images), _nchw(probs), torch.from_numpy(rois),
                               torch.from_numpy(label), weight=1.0, sigma_xy=20.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
