"""DRFL's losses of the PyTorch port (`losses/dice.py`) against the JAX package:
every loss and `drfl_generator_loss`'s parts within 1e-6, their gradients
against `jax.grad` within 1e-6 of the largest entry, and `gan_loss`'s
`ValueError`. Probabilities include exact 0 and 1 and values inside the clip's
margin, where the JAX clip and torch's log clamp would differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.losses import dice as JL
from representationlearning_tpu_torch.losses import dice as TL

torch.set_num_threads(2)

REL = 1e-6
SHAPE = (2, 16, 16, 1)


def _data(seed):
    rng = np.random.default_rng(seed)
    y_true = (rng.random(SHAPE) > 0.6).astype(np.float32)
    y_pred = rng.random(SHAPE).astype(np.float32)
    flat = y_pred.reshape(-1)
    flat[:6] = [0.0, 1.0, 1e-9, 1.0 - 1e-9, 1e-7, 0.5]   # at and inside the clip's margin
    return y_true, y_pred


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _both(fn_j, fn_t, *arrays, argnums=(0,)):
    """Value and gradients (w.r.t. ``argnums``) of the JAX and the port loss on
    the same arrays."""
    j_args = [jnp.asarray(a) for a in arrays]
    t_args = [torch.from_numpy(a.copy()).requires_grad_(i in argnums)
              for i, a in enumerate(arrays)]
    want, j_grads = jax.value_and_grad(fn_j, argnums=argnums)(*j_args)
    got = fn_t(*t_args)
    got.backward()
    return got, want, [t_args[i].grad for i in argnums], j_grads


CASES = {
    "bce": (JL.bce_loss, TL.bce_loss, "pt"),
    "soft_dice": (JL.soft_dice_loss, TL.soft_dice_loss, "tp"),
    "soft_dice_smooth": (lambda t, p: JL.soft_dice_loss(t, p, 1.0),
                         lambda t, p: TL.soft_dice_loss(t, p, 1.0), "tp"),
    "dice_bce": (JL.dice_bce_loss, TL.dice_bce_loss, "tp"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name):
    fn_j, fn_t, order = CASES[name]
    y_true, y_pred = _data(1)
    args = (y_pred, y_true) if order == "pt" else (y_true, y_pred)
    pred_at = order.index("p")
    got, want, (g_t,), (g_j,) = _both(fn_j, fn_t, *args, argnums=(pred_at,))
    _close(got, want)
    _close(g_t, g_j)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    logits = np.random.default_rng(2).normal(0.0, 3.0, (2, 8, 8, 1)).astype(np.float32)
    got, want, (g_t,), (g_j,) = _both(lambda p: JL.gan_loss(p, real, mode),
                                      lambda p: TL.gan_loss(p, real, mode), logits)
    _close(got, want)
    _close(g_t, g_j)


def test_gan_loss_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="wgan"):
        TL.gan_loss(torch.zeros(2), True, "wgan")


def test_generator_loss_parts_and_gradients_match_jax():
    """`drfl_generator_loss(out2, out, binm, C, gt)`: the total and its three parts,
    and the gradients of the total w.r.t. the three predictions."""
    rng = np.random.default_rng(3)
    y_true, out = _data(4)
    _, binm = _data(5)
    out2 = rng.random((2, 32, 32, 1)).astype(np.float32)
    soft = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    arrays = (out2, out, binm, soft, y_true)
    (total_j, parts_j), grads_j = jax.value_and_grad(
        JL.drfl_generator_loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, arrays))
    t_args = [torch.from_numpy(a.copy()).requires_grad_(i < 3) for i, a in enumerate(arrays)]
    total_t, parts_t = TL.drfl_generator_loss(*t_args)
    total_t.backward()
    _close(total_t, total_j)
    assert set(parts_t) == set(parts_j) == {"G_L1", "G_bin", "bin"}
    for k in parts_j:
        _close(parts_t[k], parts_j[k])
    for t, g in zip(t_args[:3], grads_j):
        _close(t.grad, g)
