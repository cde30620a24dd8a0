"""The RML mutual-information losses of the port (`losses/mi.py`) against the JAX
package's, f32, on the same numpy inputs (NCHW here, NHWC there): the two torch
quirks included (probabilities as kl_div's log-input with 0 * log 0 = 0, the +-1
sign-cosine matrix), maps that hold 255 and targets with zero probabilities, and
where each loss sends its gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.losses import mi as JM
from representationlearning_tpu_torch.losses import mi as TM

torch.set_num_threads(2)
TOL = 2e-6


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _close(got, want):
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("zeros", [False, True])
def test_kl_div_mean(zeros):
    rng = np.random.default_rng(0)
    inp = rng.random((5, 12)).astype(np.float32)
    tgt = rng.random((5, 12)).astype(np.float32)
    if zeros:  # zero-probability targets: 0 * log 0 = 0, the input term vanishes too
        tgt[:, ::3] = 0.0
        tgt[2] = 0.0
    tgt /= np.maximum(tgt.sum(1, keepdims=True), 1e-12)
    got = TM.torch_kl_div_mean(torch.from_numpy(inp), torch.from_numpy(tgt))
    _close(got, JM.torch_kl_div_mean(jnp.asarray(inp), jnp.asarray(tgt)))
    # F.kl_div's own value where it is defined (no zero targets: torch gives nan there)
    if not zeros:
        want = torch.nn.functional.kl_div(torch.from_numpy(inp), torch.from_numpy(tgt),
                                          reduction="mean")
        _close(got, want)


@pytest.mark.parametrize("dim", [1, 3])
def test_feat_feat_mi(dim):
    rng = np.random.default_rng(dim)
    f1 = rng.standard_normal((2, dim, 6, 7)).astype(np.float32) * 0.1
    f2 = rng.standard_normal((2, dim, 6, 7)).astype(np.float32) * 0.1
    got = TM.feat_feat_mi_estimation(torch.from_numpy(f1), torch.from_numpy(f2))
    _close(got, JM.feat_feat_mi_estimation(_nhwc(f1), _nhwc(f2), dim=dim))


def test_feat_feat_mi_sends_its_gradient_to_f2_only():
    rng = np.random.default_rng(4)
    f1, f2 = (torch.from_numpy(rng.standard_normal((2, 3, 5, 5)).astype(np.float32) * 0.1)
              .requires_grad_() for _ in range(2))
    TM.feat_feat_mi_estimation(f1, f2).backward()
    assert f1.grad is None and f2.grad.abs().max() > 0


@pytest.mark.parametrize("with_255", [False, True])
def test_feat_label_mi(with_255):
    rng = np.random.default_rng(5)
    feat = rng.random((2, 8, 9)).astype(np.float32)
    y = rng.integers(0, 4, (2, 8, 9)).astype(np.int64)
    if with_255:   # ignored pixels: softmax(255 / 0.05) is one-hot on them
        y[0, :2] = 255
        y[1, 3, 4] = 255
    f = torch.from_numpy(feat).requires_grad_()
    got = TM.feat_label_mi_estimation(f, torch.from_numpy(y))
    _close(got, JM.feat_label_mi_estimation(jnp.asarray(feat), jnp.asarray(y)))
    assert not got.requires_grad   # the reference detaches the prediction


def test_sign_cosine_matrix():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 7)).astype(np.float32)
    a[0, 2] = 0.0   # the 1e-8 clamp: 0 / 1e-8 = 0
    b = rng.standard_normal((3, 7)).astype(np.float32)
    got = TM._sign_cosine_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JM._sign_cosine_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert set(np.unique(got)) <= {-1.0, 0.0, 1.0}


def test_ciml_loss():
    rng = np.random.default_rng(7)
    c1 = rng.standard_normal((2, 20, 6, 6)).astype(np.float32)
    c2 = rng.standard_normal((2, 20, 6, 6)).astype(np.float32)
    got = TM.ciml_loss(torch.from_numpy(c1), torch.from_numpy(c2))
    _close(got, JM.ciml_loss(_nhwc(c1), _nhwc(c2)))


def test_mfml_loss_and_its_gradient():
    rng = np.random.default_rng(8)
    s1 = rng.standard_normal((2, 15, 6, 5)).astype(np.float32) * 0.2
    s2 = rng.standard_normal((2, 15, 6, 5)).astype(np.float32) * 0.2
    t1, t2 = (torch.from_numpy(s).requires_grad_() for s in (s1, s2))
    got = TM.mfml_loss(t1, t2)
    _close(got, JM.mfml_loss(_nhwc(s1), _nhwc(s2)))
    got.backward()
    g1, g2 = jax.grad(lambda a, b: JM.mfml_loss(a, b), argnums=(0, 1))(_nhwc(s1), _nhwc(s2))
    for t, g in ((t1, g1), (t2, g2)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-7)
    assert (t1.grad[:, 0] == 0).all()   # channel 0 is dropped


@pytest.mark.parametrize("with_255", [False, True])
def test_apml_mi_terms_and_their_gradient(with_255):
    rng = np.random.default_rng(9)
    a1 = rng.random((2, 16, 16)).astype(np.float32)
    a2 = rng.random((2, 16, 16)).astype(np.float32)
    lab = rng.integers(0, 3, (2, 24, 24)).astype(np.int64)
    if with_255:
        lab[:, :, 18:] = 255
    t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (a1, a2))
    got = TM.apml_mi_terms(t1, t2, torch.from_numpy(lab))
    want = JM.apml_mi_terms(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(lab))
    _close(got, want)
    got.backward()
    g1, g2 = jax.grad(lambda a, b: JM.apml_mi_terms(a, b, jnp.asarray(lab)),
                      argnums=(0, 1))(jnp.asarray(a1), jnp.asarray(a2))
    for t, g in ((t1, g1), (t2, g2)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())
