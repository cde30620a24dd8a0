"""The CGFL losses (`losses/cgfl.py`) and the discriminative loss
(`losses/discriminative.py`) of the port against the JAX package's, at
(2, 7, 16, 16) logits (NCHW here, NHWC there) from one numpy seed, masks with the
ignore label -1, 255 (outside the classes, so ignored too) and classes absent
from an image. Values within 1e-6 relative (f32, sums over 512 pixels in
another order); gradients with respect to the logits and the aux logits
(`jax.grad` against `torch.autograd`) within 1e-6 of their largest entry. The
stop-gradients of the reference leave the aux logits without any gradient:
exactly zero on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.losses import cgfl as JC
from representationlearning_tpu.losses import discriminative as JD
from representationlearning_tpu_torch.losses import cgfl as TC
from representationlearning_tpu_torch.losses import discriminative as TD

torch.set_num_threads(2)

RTOL = 1e-6
B, C, H, W = 2, 7, 16, 16
FULL = {"ce": {}, "fcloss": {"gamma": 2.0}, "bceloss": {"scaler": 0.5},
        "tverloss": {"alpha": 0.3, "beta": 0.7, "scaler": 0.25}, "diceloss": {"scaler": 2.0}}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((B, H, W, C))).astype(np.float32)
    aux = rng.standard_normal((B, C)).astype(np.float32)
    mask = rng.integers(0, 4, (B, H, W))          # image 0: classes 0-3 only
    mask[1] = rng.choice([0, 2, 5, 6], (H, W))    # image 1: 1, 3, 4 absent
    mask[rng.random((B, H, W)) < 0.1] = -1
    mask[rng.random((B, H, W)) < 0.05] = 255
    return logits, aux, mask


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(grad) if grad else t


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _close(got, want, what=""):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    assert abs(got - want) <= RTOL * max(abs(want), 1e-30), (what, got, want)


def _grads_close(got, want, what=""):
    """Gradients within RTOL of their largest entry; both zero where one is."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL * scale, (what, np.abs(got - want).max(), scale)


# each case: the port's function of (logits NCHW, aux, mask) and JAX's of (logits NHWC, aux, mask)
CASES = {
    "softmax_focalloss": (
        lambda y, a, m: TC.softmax_focalloss(y, m, torch.tensor([0.3, 1.7]), -1),
        lambda y, a, m: JC.softmax_focalloss(y, m, jnp.array([0.3, 1.7]), -1)),
    "softmax_focalloss_pow": (
        lambda y, a, m: TC.softmax_focalloss_pow(y, m, 2.0, -1),
        lambda y, a, m: JC.softmax_focalloss_pow(y, m, 2.0, -1)),
    "softmax_focalloss_pow_normalized": (
        lambda y, a, m: TC.softmax_focalloss_pow(y, m, 1.5, -1, normalize=True),
        lambda y, a, m: JC.softmax_focalloss_pow(y, m, 1.5, -1, normalize=True)),
    "binary_cross_entropy_with_logits_ignore": (
        lambda y, a, m: TC.binary_cross_entropy_with_logits_ignore(
            y[:, 0], TC._background_target(m, -1), -1),
        lambda y, a, m: JC.binary_cross_entropy_with_logits_ignore(
            y[..., 0], jnp.where(m > 0, 1.0, jnp.where(m == -1, -1.0, 0.0)), -1)),
    "tversky_loss_with_logits": (
        lambda y, a, m: TC.tversky_loss_with_logits(
            y[:, 0], TC._background_target(m, -1), 0.3, 0.7, -1),
        lambda y, a, m: JC.tversky_loss_with_logits(
            y[..., 0], jnp.where(m > 0, 1.0, jnp.where(m == -1, -1.0, 0.0)), 0.3, 0.7, -1)),
    "dice_loss_with_logits": (
        lambda y, a, m: TC.dice_loss_with_logits(y, m, -1),
        lambda y, a, m: JC.dice_loss_with_logits(y, m, -1)),
    "segmentation_loss_aux_ce": (
        lambda y, a, m: sum(TC.segmentation_loss_aux(y, m, a, {"ce": {}}, -1).values()),
        lambda y, a, m: sum(JC.segmentation_loss_aux(y, m, a, {"ce": {}}, -1).values())),
    "segmentation_loss_aux_full": (
        lambda y, a, m: sum(TC.segmentation_loss_aux(y, m, a, FULL, -1).values()),
        lambda y, a, m: sum(JC.segmentation_loss_aux(y, m, a, FULL, -1).values())),
    "segmentation_loss_full": (
        lambda y, a, m: sum(TC.segmentation_loss(y, m, FULL, -1).values()),
        lambda y, a, m: sum(JC.segmentation_loss(y, m, FULL, -1).values())),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax(name):
    port_fn, jax_fn = CASES[name]
    logits, aux, mask = _inputs()
    want, (g_y, g_a) = jax.value_and_grad(
        lambda y, a: jax_fn(y, a, jnp.asarray(mask)), argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(aux))
    y, a = _t(_nchw(logits), True), _t(aux, True)
    got = port_fn(y, a, _t(mask))
    _close(got, want, name)
    gy, ga = torch.autograd.grad(got, (y, a), allow_unused=True)
    _grads_close(gy, _nchw(g_y), name + " d/dlogits")
    assert np.abs(np.asarray(g_y)).max() > 0
    if ga is None:   # the aux logits are not in the port's graph: JAX's is all zeros
        assert not np.asarray(g_a).any()
    else:
        _grads_close(ga, g_a, name + " d/daux")


@pytest.mark.parametrize("config", [{"ce": {}}, FULL])
def test_loss_dicts_match_jax_term_by_term(config):
    logits, aux, mask = _inputs(1)
    want = JC.segmentation_loss_aux(jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(aux),
                                    config, -1)
    got = TC.segmentation_loss_aux(_t(_nchw(logits)), _t(mask), _t(aux), config, -1)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], k)
    want = JC.segmentation_loss(jnp.asarray(logits), jnp.asarray(mask), config, -1)
    got = TC.segmentation_loss(_t(_nchw(logits)), _t(mask), config, -1)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], k)


def test_aux_logits_get_exactly_zero_gradient_in_the_step_loss():
    """The dynamic gamma reaches the loss only through the detached factor: JAX's
    gradient on the aux logits is all zeros, and in the port they are not in the
    graph (a zero gradient where one is asked for)."""
    logits, aux, mask = _inputs(2)
    g = jax.grad(lambda a: sum(JC.segmentation_loss_aux(
        jnp.asarray(logits), jnp.asarray(mask), a, {"ce": {}}, -1).values()))(jnp.asarray(aux))
    assert not np.asarray(g).any()
    a = _t(aux, True)
    loss = sum(TC.segmentation_loss_aux(_t(_nchw(logits), True), _t(mask), a, {"ce": {}},
                                        -1).values())
    (ga,) = torch.autograd.grad(loss, (a,), allow_unused=True, materialize_grads=True)
    assert torch.equal(ga, torch.zeros_like(ga))


@pytest.mark.parametrize("binary", [True, False])
def test_mctrans_aux_l1_matches_jax(binary):
    """Membership against arange(C): over the 0/1 background map only columns 0
    and 1 can be set (the reference's behaviour), over a label map any class."""
    logits, aux, mask = _inputs(3)
    m = (mask > 0).astype(np.float32) if binary else mask.astype(np.float32)
    wl, wl1 = JC.mctrans_aux_l1(jnp.asarray(aux), jnp.asarray(m), C)
    gl, gl1 = TC.mctrans_aux_l1(_t(aux), _t(m), C)
    assert float(gl) == float(wl) == 0.0
    np.testing.assert_allclose(gl1.numpy(), np.asarray(wl1), rtol=RTOL, atol=0)


def test_focal_gamma_changes_the_loss_not_its_direction():
    """gamma scales the gathered factor (1 - gamma / 7) per sample."""
    logits, _, mask = _inputs(4)
    y = _t(_nchw(logits))
    lo = TC.softmax_focalloss(y, _t(mask), torch.tensor([0.0, 0.0]))
    hi = TC.softmax_focalloss(y, _t(mask), torch.tensor([3.5, 3.5]))
    assert abs(float(hi) - 0.5 * float(lo)) <= RTOL * float(lo)


@pytest.mark.parametrize("norm", [1, 2])
def test_discriminative_loss_matches_jax(norm):
    """Embeddings (2, 4, 16, 16), 5 instance ids with an absent one, negative and
    out-of-range ids ignored: the total and its three terms."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((B, H, W, 4)).astype(np.float32)
    lab = rng.integers(0, 4, (B, H, W))
    lab[1][lab[1] == 2] = 4
    lab[rng.random((B, H, W)) < 0.1] = -1
    lab[rng.random((B, H, W)) < 0.05] = 9
    want, wparts = JD.discriminative_loss(jnp.asarray(emb), jnp.asarray(lab), 5, norm=norm)
    got, parts = TD.discriminative_loss(_t(_nchw(emb)), _t(lab), 5, norm=norm)
    _close(got, want, "total")
    for k in ("var", "dist", "reg"):
        _close(parts[k], wparts[k], k)
    assert float(parts["dist"]) > 0 and float(parts["var"]) > 0
