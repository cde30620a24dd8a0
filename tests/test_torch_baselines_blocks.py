"""The building blocks of `models/baselines.py` against the JAX package's on
the same seeded, calmed weights and numpy inputs, f32, within 2e-5 of max(1,
largest), in eval mode and, where a block has BatchNorms, in training mode with
the running statistics it leaves: FPN, AsymmetricDecoder, FSRelation,
VGG16Features, PSPModule at maps where its pools crop (8 x 8 at s = 3 and 6),
and multi_binary_loss at label_smooth 0 and 0.1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import zoo_common as Z
from representationlearning_tpu.models import baselines as JB
from representationlearning_tpu_torch.models import baselines as TB

torch.set_num_threads(2)


def _maps(seed, widths, side=16, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, side >> i, side >> i, c)).astype(np.float32)
            for i, c in enumerate(widths)]


def test_fpn_matches_jax():
    widths = (8, 16, 24, 32)
    out = Z.block_matches(TB.FPN(widths, 16), JB.FPN(16), _maps(0, widths))
    assert [tuple(o.shape) for o in out] == [(2, 16, 16 >> i, 16 >> i) for i in range(4)]


def test_asymmetric_decoder_matches_jax():
    out = Z.block_matches(TB.AsymmetricDecoder(12, 8), JB.AsymmetricDecoder(8),
                          _maps(1, (12,) * 4))
    assert tuple(out.shape) == (2, 8, 16, 16)


def test_fs_relation_matches_jax():
    scene = np.random.default_rng(2).standard_normal((2, 2, 2, 40)).astype(np.float32)
    Z.block_matches(TB.FSRelation(40, (16,) * 4, 24, 12), JB.FSRelation(24, 12), scene,
                    _maps(3, (16,) * 4))


def test_vgg16_features_matches_jax():
    x = np.random.default_rng(4).standard_normal((1, 64, 48, 3)).astype(np.float32)
    out = Z.block_matches(TB.VGG16Features(), JB.VGG16Features(), x, train_arg=False)
    assert [tuple(o.shape) for o in out] == [(1, 256, 8, 6), (1, 512, 4, 3), (1, 512, 2, 1)]


@pytest.mark.parametrize("side", [8, 12, 7])
def test_psp_module_matches_jax(side):
    """At an 8 x 8 map the pools at s = 3 and 6 average the floor-cropped
    region, not what F.adaptive_avg_pool2d averages."""
    x = np.random.default_rng(5).standard_normal((2, side, side, 16)).astype(np.float32)
    port = TB.PSPModule(16, 12)
    Z.block_matches(port, JB.PSPModule(12), x, train_arg=False)
    if side == 8:
        t = Z.nchw(x)
        crop = t[:, :, :6, :6].reshape(2, 16, 3, 2, 3, 2).mean(dim=(3, 5))
        assert not torch.allclose(crop, F.adaptive_avg_pool2d(t, 3), atol=1e-3)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_multi_binary_loss_matches_jax(smooth):
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((2, 16, 16, 6)).astype(np.float32) * 2
    y = rng.integers(-1, 7, (2, 16, 16)).astype(np.int32)
    want = float(JB.multi_binary_loss(jnp.asarray(pred), jnp.asarray(y), 6, 1.5, 0.5, smooth))
    got = float(TB.multi_binary_loss(Z.nchw(pred), torch.from_numpy(y).long(), 6, 1.5, 0.5,
                                     smooth))
    assert abs(got - want) <= Z.MODULE_TOL * abs(want), (got, want)
