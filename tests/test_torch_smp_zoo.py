"""The second half of the baseline zoo (`models/smp_zoo.py`: UNetPP, DeepLabV3
and MANet here, LinkNet, DeepLabV3Plus and PAN in test_torch_smp_zoo_f64.py)
against the JAX package on the same
calmed weights and numpy-seeded inputs, 2 x 64 x 64, labels with -1 pixels:
eval probabilities in f32 within 2e-4 of max(1, largest); the training loss
dict within 1e-5 relative, the running statistics after it within 1e-4 of
max(largest, 1e-3) and the gradient norm of each top-level module within 1e-3
relative against `jax.grad` of JAX's training apply (one jit a model).

The training comparison of the three others is in f64 (see that file).

The building blocks against the JAX modules on seeded, calmed weights, within
2e-5 of max(1, largest), in eval and training mode with the running statistics
they leave: the zoo's ConvBNReLU with a dilation, DoubleConv, ASPP, PAB, MFAB,
GAU, LinkNetDecoderBlock, and FPA at 1 x 1, 2 x 2, 3 x 3 and 5 x 7 maps, where
its pyramid has no level or stops early."""
import numpy as np
import pytest
import torch

import zoo_common as Z
from representationlearning_tpu.models import smp_zoo as JZ
from representationlearning_tpu_torch.models import smp_zoo as TZ

torch.set_num_threads(2)

NAMES = ("UNetPP", "DeepLabV3", "MANet")


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_jax(name):
    Z.model_matches_jax(name, f64_train=False)


def _map(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("k,dilation", [(3, 2), (1, 1), (3, 1)])
def test_conv_bn_relu_matches_jax(k, dilation):
    out = Z.block_matches(TZ.ConvBNReLU(6, 10, k, dilation), JZ.ConvBNReLU(10, k, dilation),
                          _map(0, (2, 9, 11, 6)))
    assert tuple(out.shape) == (2, 10, 9, 11)


def test_double_conv_matches_jax():
    Z.block_matches(TZ.DoubleConv(6, 8), JZ.DoubleConv(8), _map(1, (2, 8, 8, 6)))


def test_aspp_matches_jax():
    """Rates 12 / 24 / 36 on a map smaller than the largest dilation, and the
    broadcast image-pool branch."""
    Z.block_matches(TZ.ASPP(12, 8), JZ.ASPP(8), _map(2, (2, 9, 7, 12)))


def test_pab_matches_jax():
    Z.block_matches(TZ.PAB(20, 6), JZ.PAB(6), _map(3, (2, 5, 6, 20)))


def test_mfab_matches_jax():
    """The SE hidden width max(C // 16, 4): 4 at 40 skip channels."""
    port = TZ.MFAB(24, 40, 16)
    assert port.se1.out_features == 4
    out = Z.block_matches(port, JZ.MFAB(16), _map(4, (2, 4, 4, 24)), _map(5, (2, 8, 8, 40)))
    assert tuple(out.shape) == (2, 16, 8, 8)


def test_gau_matches_jax():
    Z.block_matches(TZ.GAU(8, 24, 8), JZ.GAU(8), _map(6, (2, 4, 4, 8)), _map(7, (2, 8, 8, 24)))


def test_linknet_decoder_block_matches_jax():
    out = Z.block_matches(TZ.LinkNetDecoderBlock(32, 12), JZ.LinkNetDecoderBlock(12),
                          _map(8, (2, 4, 4, 32)), (9, 8))
    assert tuple(out.shape) == (2, 12, 9, 8)


@pytest.mark.parametrize("hw,levels", [((1, 1), 0), ((2, 2), 1), ((3, 3), 1), ((5, 7), 2)])
def test_fpa_matches_jax(hw, levels):
    """The pyramid's depth follows the map: no level at 1 x 1 (the middle branch
    times ones), one at 2 x 2 and 3 x 3, two at 5 x 7 (2 x 3, then 1 x 1)."""
    port = TZ.FPA(12, 8)
    calls = []
    for i in range(1, 4):
        getattr(port, f"d{i}").register_forward_hook(lambda *a, i=i: calls.append(i))
    Z.block_matches(port, JZ.FPA(8), _map(9, (2,) + hw + (12,)))
    assert calls == list(range(1, levels + 1)) * 2     # eval, training
