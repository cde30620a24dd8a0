"""Layers and image ops of the PyTorch port against the JAX package: bilinear
resize (both corner conventions), the 1x1 pools, `AttnProj` on converted
weights, and the seeded initialisers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.layers import AttnProj as JAttnProj
from representationlearning_tpu.ops import image as jimage
from representationlearning_tpu_torch.convert.from_jax import state_dict_from_jax
from representationlearning_tpu_torch.models import layers
from representationlearning_tpu_torch.ops import image

torch.set_num_threads(2)

# f32 interpolation: both sides blend the same two taps with the same weights;
# only the rounding of the source coordinate and of the blend differ
ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("size", [(16, 16), (7, 5), (32, 24)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(size, align_corners):
    x = np.random.default_rng(0).standard_normal((2, 11, 9, 3)).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), size, align_corners))
    got = image.resize_bilinear(_nchw(x), size, align_corners=align_corners)
    assert got.shape == (2, 3) + size
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=ATOL)


def test_resize_bilinear_keeps_dtype_and_leading_dims():
    x = torch.randn(2, 4, 3, 6, 5, generator=torch.Generator().manual_seed(0))
    got = image.resize_bilinear(x.to(torch.bfloat16), (12, 10))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 3, 12, 10)
    assert image.resize_bilinear(x, (6, 5)) is x  # same size: untouched


def test_pools_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 4)).astype(np.float32)
    for jfn, fn in ((jimage.adaptive_max_pool_11, image.adaptive_max_pool_11),
                    (jimage.adaptive_avg_pool_11, image.adaptive_avg_pool_11)):
        want = np.asarray(jfn(jnp.asarray(x)))                   # (B, 1, 1, C)
        got = fn(_nchw(x))                                        # (B, C, 1, 1)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-6)


def test_attn_proj_matches_jax():
    """The per-map contraction over two (B, nh, N, N) maps plus bias, on the
    JAX module's converted weights; the state_dict is a 1x1 conv's."""
    rng = np.random.default_rng(2)
    maps = [rng.standard_normal((2, 8, 16, 16)).astype(np.float32) for _ in range(2)]
    jm = JAttnProj(16)
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(m) for m in maps])
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": jnp.asarray(rng.standard_normal(1), jnp.float32)}}
    want = np.asarray(jm.apply(v, [jnp.asarray(m) for m in maps]))
    tm = layers.AttnProj(16)
    tm.load_state_dict(state_dict_from_jax(v))
    assert tm.weight.shape == (1, 16, 1, 1)
    with torch.no_grad():
        got = tm([torch.from_numpy(m) for m in maps])
    assert got.shape == (2, 16, 16) and got.dtype == torch.float32
    # f32 sums of 16 products in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    conv = torch.nn.functional.conv2d(torch.from_numpy(np.concatenate(maps, 1)), tm.weight,
                                      tm.bias)[:, 0]
    np.testing.assert_allclose(got.detach().numpy(), conv.detach().numpy(), atol=1e-5)


def test_initialisers_are_seeded_and_scaled():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (layers.trunc_normal_init(torch.empty(256, 256), generator=g),
                layers.fan_out_conv_init(torch.empty(64, 32, 3, 3), generator=g))

    (t, c), (t2, c2), (t3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(t, t2) and torch.equal(c, c2) and not torch.equal(t, t3)
    assert t.abs().max() <= 0.04  # truncated at 2 std
    # truncated N(0, 0.02) at +-2 std has std 0.02 * 0.8796
    assert abs(t.std().item() - 0.02 * 0.8796) < 5e-4
    # JAX `fan_out_conv_init` for the same (ungrouped) conv: sqrt(2 / (kh kw out))
    assert abs(c.std().item() - (2.0 / (3 * 3 * 64)) ** 0.5) < 3e-3


def test_drop_path_is_identity_in_eval_and_per_sample_in_training():
    dp = layers.DropPath(0.5)
    x = torch.ones(64, 3, 4)
    assert dp.eval()(x) is x
    y = dp.train()(x)
    per_sample = y.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (per_sample.min(1).values == per_sample.max(1).values).all()
