"""The port's slice end to end: TSCD(mit_b0) with fused blocks against the JAX
TSCD on the same weights (the port's state_dict through `convert_tscd`) and the
same numpy-seeded 64 x 64 images."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_tscd, state_dict_to_numpy
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.ops import mit_block as tmb

torch.set_num_threads(2)

# f32 end to end, the bound of tests/test_parity_torch_e2e.py:21
ATOL = 2e-4
# bf16 (dtype=act_dtype=bf16): the residual stream is rounded to bf16 after each
# block and the head stores its embeds in bf16, so where the two frameworks'
# f32 sums land on either side of a bf16 rounding boundary the results move by
# one bf16 spacing (2^-8 to 2^-7 relative) and that propagates. Bound: 2e-2 of
# the output's largest magnitude, about 2.5 bf16 spacings.
BF16_REL = 2e-2


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    tm = TSCD("mit_b0", 21, fused_blocks=True, generator=torch.Generator().manual_seed(0),
              device="cpu")
    sd = tm.state_dict()
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), sd, \
        convert_tscd(state_dict_to_numpy(sd))


def _port(sd, **kw):
    m = TSCD("mit_b0", 21, device="cpu", **kw).eval()
    m.load_state_dict(sd)
    return m


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("pooling", ["gmp", "gap"])
def test_tscd_fused_f32_matches_jax(setup, pooling):
    x, xt, sd, v = setup
    j_cls, j_seg, j_attns, j_pred = JTSCD(backbone="mit_b0", num_classes=21,
                                          fused_blocks=True, pooling=pooling).apply(
        v, jnp.asarray(x))
    tmb.reset_launches()
    with torch.no_grad():
        cls, seg, attns, pred = _port(sd, fused_blocks=True, pooling=pooling)(xt)
    assert cls.shape == (2, 20) and seg.shape == (2, 21, 16, 16)
    assert pred.shape == (2, 16, 16) and [a.shape for a in attns] == [(2, 8, 16, 16)] * 2
    np.testing.assert_allclose(cls.numpy(), np.asarray(j_cls), atol=ATOL)
    np.testing.assert_allclose(_nhwc(seg), np.asarray(j_seg), atol=ATOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=ATOL)
    for a, ja in zip(attns, j_attns):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    assert sum(tmb.LAUNCHES.values()) == 0  # CPU tensors: plain versions only


def test_tscd_cam_only_matches_jax(setup):
    x, xt, sd, v = setup
    j_cam, j_pred = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True).apply(
        v, jnp.asarray(x), cam_only=True)
    with torch.no_grad():
        cam, pred = _port(sd, fused_blocks=True)(xt, cam_only=True)
    assert cam.shape == (2, 20, 4, 4)
    np.testing.assert_allclose(_nhwc(cam), np.asarray(j_cam), atol=ATOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=ATOL)


def test_tscd_fused_bf16_matches_jax_bf16(setup):
    """The headline configuration (dtype = act_dtype = bf16, fused blocks)."""
    x, xt, sd, v = setup
    j_cls, j_seg, _, j_pred = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True,
                                    dtype=jnp.bfloat16, act_dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x))
    with torch.no_grad():
        cls, seg, _, pred = _port(sd, fused_blocks=True, dtype=torch.bfloat16,
                                  act_dtype=torch.bfloat16)(xt)
    for got, want in ((cls.float().numpy(), np.asarray(j_cls, np.float32)),
                      (_nhwc(seg), np.asarray(j_seg, np.float32)),
                      (pred.numpy(), np.asarray(j_pred, np.float32))):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=BF16_REL * np.abs(want).max())
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_tscd_collect_attns_none_has_no_attn_pred(setup):
    _, xt, sd, _ = setup
    with torch.no_grad():
        cls, seg, attns, pred = _port(sd, fused_blocks=True, collect_attns="none")(xt)
    assert attns == [] and pred is None and seg.shape == (2, 21, 16, 16)


def test_tscd_fused_and_plain_blocks_agree(setup):
    """fused_blocks flips on the same state_dict (JAX `test_tscd_fused_blocks_same_
    params_same_outputs`)."""
    _, xt, sd, _ = setup
    with torch.no_grad():
        a = _port(sd, fused_blocks=True)(xt)
        b = _port(sd, fused_blocks=False)(xt)
    for u, w in ((a[0], b[0]), (a[1], b[1]), (a[3], b[3])):
        np.testing.assert_allclose(u.numpy(), w.numpy(), atol=1e-4)
