"""`losses/wsss.py` and the new image ops of the PyTorch port against the JAX
package on the same numpy-seeded inputs: values and, where the loss trains
something, gradients. The port is NCHW, the JAX package NHWC."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.losses import wsss as JW
from representationlearning_tpu.ops import image as JI
from representationlearning_tpu_torch.losses import wsss as TW
from representationlearning_tpu_torch.ops import image as TI

torch.set_num_threads(2)

# f32 on both sides; sums over at most a few thousand terms in another order
ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got, want, atol=ATOL, rtol=1e-5):
    if isinstance(want, torch.Tensor):
        want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_multilabel_soft_margin_loss_value_and_gradient():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 20)).astype(np.float32) * 3
    y = (rng.random((4, 20)) < 0.2).astype(np.float32)
    want, wg = jax.value_and_grad(JW.multilabel_soft_margin_loss)(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    got = TW.multilabel_soft_margin_loss(tx, torch.from_numpy(y))
    _close(got, want)
    _close(torch.autograd.grad(got, tx)[0], wg)
    _close(got, torch.nn.functional.multilabel_soft_margin_loss(tx, torch.from_numpy(y)))


def test_aux_loss_value_counts_and_gradient():
    rng = np.random.default_rng(1)
    p = rng.random((2, 16, 16)).astype(np.float32)
    t = rng.choice([0, 1, 255], size=(2, 16, 16)).astype(np.int32)
    (want, (wp, wn)), wg = jax.value_and_grad(
        lambda a: (lambda r: (r[0], (r[1], r[2])))(JW.aux_loss(a, jnp.asarray(t))),
        has_aux=True)(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    got, pos, neg = TW.aux_loss(tp, torch.from_numpy(t))
    _close(got, want)
    assert float(pos) == float(wp) and float(neg) == float(wn)
    _close(torch.autograd.grad(got, tp)[0], wg)


def test_select_class_is_the_one_hot_contraction():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    idx = rng.integers(0, 7, size=(2, 5, 6))
    want = JW.select_class(jnp.asarray(x), jnp.asarray(idx))
    got = TW.select_class(_nchw(x), torch.from_numpy(idx))
    assert got.shape == (2, 5, 6)
    _close(got, want, atol=0)


@pytest.mark.parametrize("case", ["mixed", "all_ignored", "out_of_range"])
def test_cross_entropy_ignore_matches_jax_and_torch(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 8, 5)).astype(np.float32)
    lab = rng.integers(0, 5, size=(2, 9, 8))
    if case == "mixed":
        lab[rng.random(lab.shape) < 0.3] = 255
    elif case == "all_ignored":
        lab[:] = 255
    else:
        lab[0, 0, :3] = 7  # not a class: counts as ignored
        lab[1, 2, :2] = -1
    want, wg = jax.value_and_grad(JW.cross_entropy_ignore)(jnp.asarray(x), jnp.asarray(lab))
    tx = _nchw(x).requires_grad_()
    got = TW.cross_entropy_ignore(tx, torch.from_numpy(lab))
    _close(got, want)
    _close(torch.autograd.grad(got, tx)[0].permute(0, 2, 3, 1), wg)
    if case == "mixed":
        _close(got, torch.nn.functional.cross_entropy(tx, torch.from_numpy(lab),
                                                      ignore_index=255))


def test_seg_loss_value_and_gradient():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 12, 21)).astype(np.float32)
    lab = rng.choice([0, 0, 3, 17, 255], size=(2, 12, 12))
    want, wg = jax.value_and_grad(JW.seg_loss)(jnp.asarray(x), jnp.asarray(lab))
    tx = _nchw(x).requires_grad_()
    got = TW.seg_loss(tx, torch.from_numpy(lab))
    _close(got, want)
    _close(torch.autograd.grad(got, tx)[0].permute(0, 2, 3, 1), wg)


def test_grid_sample_pad_and_std_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    grid = (rng.random((2, 5, 6, 2)).astype(np.float32) * 2.4 - 1.2)  # some outside [-1, 1]
    want = JI.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid))
    got = TI.grid_sample_bilinear(_nchw(x), torch.from_numpy(grid))
    assert got.shape == (2, 4, 5, 6)
    _close(got.permute(0, 2, 3, 1), want)
    _close(TI.pad_replicate(_nchw(x), 2).permute(0, 2, 3, 1), JI.pad_replicate(jnp.asarray(x), 2),
           atol=0)
    _close(TI.torch_std(_nchw(x), (2, 3), keepdims=True).permute(0, 2, 3, 1),
           JI.torch_std(jnp.asarray(x), (1, 2), keepdims=True))


def test_tensor_correlation_and_equivariance_loss():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((2, 6, 2, 5)).astype(np.float32)
    _close(TW.tensor_correlation(_nchw(a), _nchw(b)),
           JW.tensor_correlation(jnp.asarray(a), jnp.asarray(b)))
    c = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    _close(TW.equivariance_loss(_nchw(a), _nchw(c)),
           JW.equivariance_loss(jnp.asarray(a), jnp.asarray(c)))


def jax_corr_coords(key, batch, n):
    """The coordinates `contrastive_corr_loss` of the JAX package draws from key
    (`losses/wsss.py:95-98`)."""
    k1, k2 = jax.random.split(key)
    shape = (batch, n, n, 2)
    return (np.array(jax.random.uniform(k1, shape) * 2.0 - 1.0),
            np.array(jax.random.uniform(k2, shape) * 2.0 - 1.0))


def test_contrastive_corr_loss_on_shared_coordinates():
    rng = np.random.default_rng(7)
    feats = rng.random((2, 16, 16, 4)).astype(np.float32)
    feats_pos = rng.random((2, 6, 6, 4)).astype(np.float32)
    code = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    code_pos = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, (wg, wg_pos) = jax.value_and_grad(
        lambda c, cp: JW.contrastive_corr_loss(key, jnp.asarray(feats), jnp.asarray(feats_pos),
                                               c, cp, n_samples=8),
        argnums=(0, 1))(jnp.asarray(code), jnp.asarray(code_pos))
    coords = tuple(torch.from_numpy(c) for c in jax_corr_coords(key, 2, 8))
    tc, tcp = _nchw(code).requires_grad_(), _nchw(code_pos).requires_grad_()
    tf = _nchw(feats).requires_grad_()
    got = TW.contrastive_corr_loss(tf, _nchw(feats_pos), tc, tcp, n_samples=8, coords=coords)
    _close(got, want, atol=1e-6)
    g, g_pos, g_feats = torch.autograd.grad(got, (tc, tcp, tf), allow_unused=True)
    _close(g.permute(0, 2, 3, 1), wg, atol=1e-6)
    _close(g_pos.permute(0, 2, 3, 1), wg_pos, atol=1e-6)
    assert g_feats is None  # the feature correlation carries no gradient


def test_contrastive_corr_loss_draws_from_its_generator():
    rng = np.random.default_rng(8)
    f, c = (_nchw(rng.random((2, 8, 8, 3)).astype(np.float32)) for _ in range(2))

    def run(seed):
        return TW.contrastive_corr_loss(f, f, c, c, n_samples=4,
                                        generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    c1, c2 = TW.sample_coords(2, 4, torch.Generator().manual_seed(0))
    assert c1.shape == c2.shape == (2, 4, 4, 2) and not torch.equal(c1, c2)
    assert -1.0 <= float(c1.min()) and float(c1.max()) < 1.0
