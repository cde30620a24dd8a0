"""The WaveCAM ResNet-50 of the PyTorch port (`models/resnet.py`) against the JAX
package: `ResNet50Backbone` at stride 16 and 8 with the stem tap, and the four
paths of `Net` (`forward`, `cam` with the classifier's weight, an external weight
and a reweighting, `cam_with_logits`, `cam_feature`), on the port's seeded weights
taken through JAX's own `convert_wavecam_net(strict=True)` (which proves the
port keeps the reference's names) and numpy-seeded 64 x 96 images; f32 and bf16.
JAX's side is computed once, in a module-scoped fixture."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import (convert_resnet50,
                                                          convert_wavecam_net,
                                                          state_dict_to_numpy)
from representationlearning_tpu.models import resnet as jr
from representationlearning_tpu_torch.convert.from_jax import (resnet50_state_dict_from_jax,
                                                               wavecam_net_state_dict_from_jax)
from representationlearning_tpu_torch.models import resnet as tr

torch.set_num_threads(2)

# f32 end to end: 2e-4 of the output's largest magnitude (the bound of
# tests/test_parity_torch_e2e.py:21, scaled to the map)
REL = 2e-4
# bf16: every conv rounds its operands and its result to bf16 at the same places in
# both frameworks, which sum in another order: 2e-2 of the largest magnitude
BF16_REL = 2e-2
H, W = 64, 96


def jitter(module, seed):
    """Noise on every FrozenBatchNorm affine and statistic, so that their wiring
    shows, scales around 0.5, so that sixteen bottlenecks keep the stream of order
    1 at random weights; the convolutions keep their initialisation."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tr.FrozenBatchNorm):
                m.weight.mul_(0.5).add_(0.05 * torch.randn(m.weight.shape, generator=g))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.add_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 0.5 + 0.75)
    return module


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _nchw(a):
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2)) if a.ndim == 4 else a


def _net(stride, dtype=torch.float32):
    return jitter(tr.Net(stride, 20, dtype=dtype, generator=torch.Generator().manual_seed(0),
                         device="cpu"), 1).eval()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    weight = rng.standard_normal((20, 2048, 1, 1)).astype(np.float32) * 0.02
    reweight = rng.random((20, 2048, 1, 1)).astype(np.float32) * 2.0
    nets = {16: _net(16), 8: _net(8), "bf16": _net(16, torch.bfloat16)}
    v = {k: convert_wavecam_net(state_dict_to_numpy(n.state_dict()), strict=True)
         for k, n in nets.items()}
    xj = jnp.asarray(x)
    want = {}
    for stride in (16, 8):
        net = jr.Net(stride=stride, n_classes=20)
        bb = {c: t["resnet50"] for c, t in v[stride].items()}
        want[("backbone", stride)] = jr.ResNet50Backbone(
            **jr.resnet50_config(stride), return_stem=True).apply(bb, xj)
        want[("cam", stride)] = net.apply(v[stride], xj, method=jr.Net.cam)
    net = jr.Net(stride=16, n_classes=20)
    v16 = v[16]
    want["forward"] = net.apply(v16, xj)
    want["cam_weight"] = net.apply(v16, xj, jnp.asarray(weight.transpose(2, 3, 1, 0)),
                                   method=jr.Net.cam)
    want["cam_reweight"] = net.apply(v16, xj, None, jnp.asarray(reweight.transpose(2, 3, 1, 0)),
                                     method=jr.Net.cam)
    want["cam_with_logits"] = net.apply(v16, xj, method=jr.Net.cam_with_logits)
    want["cam_feature"] = net.apply(v16, xj, method=jr.Net.cam_feature)
    want["bf16"] = jr.Net(stride=16, n_classes=20, dtype=jnp.bfloat16).apply(
        v["bf16"], xj, method=jr.Net.cam)
    return dict(x=torch.from_numpy(_nchw(x)), weight=torch.from_numpy(weight),
                reweight=torch.from_numpy(reweight), nets=nets, v=v, want=want)


def test_state_dict_names_are_the_reference_ones(setup):
    names = set(setup["nets"][16].state_dict())
    for k in ("resnet50.conv1.weight", "resnet50.bn1.running_var", "resnet50.bn1.weight",
              "resnet50.layer1.0.downsample.0.weight", "resnet50.layer1.0.downsample.1.bias",
              "resnet50.layer3.5.conv3.weight", "resnet50.layer4.2.bn2.running_mean",
              "classifier.weight"):
        assert k in names, k
    assert setup["nets"][16].classifier.bias is None
    assert setup["nets"][16].classifier.weight.shape == (20, 2048, 1, 1)
    assert "resnet50.layer2.1.downsample.0.weight" not in names


def test_converter_round_trip(setup):
    """The port's state_dict -> JAX's `convert_wavecam_net` -> back through
    `wavecam_net_state_dict_from_jax` is the identity; a bare backbone through
    `convert_resnet50` and `resnet50_state_dict_from_jax` too."""
    for net, v in ((setup["nets"][16], setup["v"][16]), (setup["nets"][8], setup["v"][8])):
        sd = net.state_dict()
        back = wavecam_net_state_dict_from_jax(v)
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    bb = setup["nets"][16].resnet50.state_dict()
    back = resnet50_state_dict_from_jax(convert_resnet50(state_dict_to_numpy(bb), strict=True))
    assert set(back) == set(bb) and all(torch.equal(back[k], bb[k]) for k in bb)


@pytest.mark.parametrize("stride", [16, 8])
def test_backbone_matches_jax(setup, stride):
    """Stem tap and the four layers; stride 8 keeps layers 3 and 4 at 1/8 with
    dilation 2 after each layer's first block."""
    bb = tr.ResNet50Backbone(**tr.resnet50_config(stride), return_stem=True).eval()
    bb.load_state_dict(setup["nets"][stride].resnet50.state_dict())
    with torch.no_grad():
        got = bb(setup["x"])
    want = setup["want"][("backbone", stride)]
    assert len(got) == len(want) == 5
    assert got[-1].shape == (2, 2048, H // stride, W // stride)
    for g, w in zip(got, want):
        _close(g, _nchw(w))


@pytest.mark.parametrize("stride", [16, 8])
def test_cam_matches_jax(setup, stride):
    with torch.no_grad():
        got = setup["nets"][stride].cam(setup["x"])
    assert got.shape == (2, 20, H // stride, W // stride) and got.dtype == torch.float32
    _close(got, _nchw(setup["want"][("cam", stride)]))


def test_forward_and_external_weights_match_jax(setup):
    net, want = setup["nets"][16], setup["want"]
    with torch.no_grad():
        _close(net(setup["x"]), want["forward"])
        _close(net.cam(setup["x"], weight=setup["weight"]), _nchw(want["cam_weight"]))
        _close(net.cam(setup["x"], reweight=setup["reweight"]), _nchw(want["cam_reweight"]))


def test_cam_with_logits_and_cam_feature_match_jax(setup):
    net, want = setup["nets"][16], setup["want"]
    with torch.no_grad():
        logits, cams, f = net.cam_with_logits(setup["x"])
        wl, wc, wf = want["cam_with_logits"]
        _close(logits, wl)
        _close(cams, _nchw(wc))
        _close(f, _nchw(wf))
        logits, cf, cams = net.cam_feature(setup["x"])
        wl, wcf, wc = want["cam_feature"]
        assert cf.shape == (2, 20, 2048)
        _close(logits, wl)
        _close(cf, wcf)
        _close(cams, _nchw(wc))


def test_bf16_matches_jax_bf16(setup):
    """bf16 convolutions, f32 FrozenBatchNorm, ReLU, residual and classifier: the
    CAMs come out f32 and agree with JAX's bf16 model within BF16_REL."""
    net = setup["nets"]["bf16"]
    with torch.no_grad():
        got = net.cam(setup["x"])
    assert got.dtype == torch.float32
    _close(got, _nchw(setup["want"]["bf16"]), rel=BF16_REL)
    # the stream between the convs is f32: BatchNorm's f32 parameters promote it
    blk = net.resnet50.layer1[0]
    with torch.no_grad():
        out = blk.bn1(torch.nn.functional.conv2d(torch.zeros(1, 64, 4, 4, dtype=torch.bfloat16),
                                                 blk.conv1.weight.bfloat16()))
    assert out.dtype == torch.float32


def test_frozen_batchnorm_ignores_train_mode():
    """`.train()` changes nothing: the running statistics normalise and stay."""
    net = _net(16)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        want = net.cam(x)
        net.train()
        got = net.cam(x)
    assert torch.equal(got, want)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())
    bn = net.resnet50.bn1
    y = torch.randn(1, 64, 3, 3)
    ref = ((y - bn.running_mean[:, None, None]) * torch.rsqrt(bn.running_var + 1e-5)[:, None, None]
           * bn.weight[:, None, None] + bn.bias[:, None, None])
    assert torch.allclose(bn(y), ref, atol=1e-6)


def test_net_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.Net()
    a = tr.Net(device="cpu", generator=torch.Generator().manual_seed(3))
    b = tr.Net(device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
