"""The HRNetV2 backbone of the PyTorch port against the JAX package:
`HighResolutionNet("hrnetv2_w18")` on the port's seeded weights taken through
`convert_hrnet`, the same numpy-seeded 64 x 64 images, and the pieces of a
`HighResolutionModule` one by one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_hrnet, state_dict_to_numpy
from representationlearning_tpu.models import hrnet as jh
from representationlearning_tpu_torch.models import hrnet as th
from representationlearning_tpu_torch.models.layers import BatchNorm2d, init_weights

torch.set_num_threads(2)

# f32 end to end, the bound of tests/test_parity_torch_e2e.py:21, times the
# map's largest magnitude where that exceeds 1
ATOL = 2e-4


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()))


def _jitter(module, seed):
    """Noise on every bias, norm affine and BatchNorm statistic, so that their
    wiring shows; BatchNorm scales around 0.5, so that the residual stream of
    some forty blocks stays of order 1 at random weights; the other weights keep
    their initialisation."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, BatchNorm2d):
                m.weight.mul_(0.5)
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif name.endswith(("bias", "running_mean")) or "norm" in name or ".bn" in name:
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return module


@pytest.fixture(scope="module")
def setup():
    net = th.HighResolutionNet("hrnetv2_w18")
    init_weights(net, torch.Generator().manual_seed(0))
    _jitter(net, 1).eval()
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    return net, convert_hrnet(state_dict_to_numpy(net.state_dict()), strict=True), x


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _backbone(v):
    return {c: t["backbone"] for c, t in v.items()}


def test_state_dict_names_are_the_reference_ones(setup):
    net, v, _ = setup
    names = set(net.state_dict())
    for k in ("conv1.weight", "bn2.running_var", "layer1.0.downsample.0.weight",
              "layer1.3.conv3.weight", "transition1.0.0.weight", "transition1.1.0.0.weight",
              "transition3.3.0.1.running_mean", "stage2.0.branches.1.3.bn2.weight",
              "stage3.3.fuse_layers.2.0.1.0.weight", "stage4.2.fuse_layers.0.3.1.bias",
              "stage4.0.transformer.attn.atrous_block2.conv1.weight",
              "stage3.1.transformer.attn.attn.q_proj.bias",
              "stage2.0.transformer.mlp.dw12.weight", "stage2.0.transformer.mlp.norm3.weight"):
        assert k in names, k
    assert "transition2.0.0.weight" not in names     # a kept branch of equal width: no conv
    n_blocks = sum(k.endswith("transformer.norm1.weight") for k in names)
    assert n_blocks == sum(th.STAGE_MODULES[1:]) == 8
    # strict conversion consumed every tensor but the num_batches_tracked counters
    n_leaves = sum(1 for c in v.values() for _ in _leaves(c))
    assert n_leaves == sum(not k.endswith("num_batches_tracked") for k in names)


def _leaves(tree):
    for t in tree.values():
        if isinstance(t, dict):
            yield from _leaves(t)
        else:
            yield t


@pytest.mark.parametrize("fused", [False, True])
def test_hrnet_w18_matches_jax(setup, fused):
    net, v, x = setup
    want = jh.HighResolutionNet("hrnetv2_w18", fused_mlp=fused).apply(_backbone(v), jnp.asarray(x))
    m = th.HighResolutionNet("hrnetv2_w18", fused_mlp=fused, fused_attn=fused).eval()
    m.load_state_dict(net.state_dict())
    with torch.no_grad():
        got = m(_nchw(x))
    assert [tuple(f.shape) for f in got] == [(1, 18, 16, 16), (1, 36, 8, 8), (1, 72, 4, 4),
                                             (1, 144, 2, 2)]
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_hrnet_without_transformer_matches_jax(setup):
    net, v, x = setup
    want = jh.HighResolutionNet("hrnetv2_w18", with_transformer=False).apply(
        _backbone(v), jnp.asarray(x))
    m = th.HighResolutionNet("hrnetv2_w18", with_transformer=False).eval()
    m.load_state_dict(net.state_dict(), strict=False)
    with torch.no_grad():
        got = m(_nchw(x))
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_high_resolution_module_matches_jax(setup):
    """One three-branch module of stage 3 on its own inputs."""
    net, v, _ = setup
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((1, 16 >> i, 16 >> i, 18 << i)).astype(np.float32) for i in range(3)]
    sub = {c: t["backbone"]["stage3_m1"] for c, t in v.items()}
    want = jh.HighResolutionModule(3, (18, 36, 72)).apply(sub, [jnp.asarray(a) for a in xs])
    with torch.no_grad():
        got = net.stage3[1]([_nchw(a) for a in xs])
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_transition_and_bottleneck_match_jax(setup):
    net, v, _ = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 256)).astype(np.float32)
    sub = {c: t["backbone"]["transition1"] for c, t in v.items()}
    want = jh.Transition((256,), (18, 36)).apply(sub, [jnp.asarray(x)])
    with torch.no_grad():
        got = net.transition1([_nchw(x)])
    assert [tuple(g.shape) for g in got] == [(1, 18, 8, 8), (1, 36, 4, 4)]
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    sub = {c: t["backbone"]["layer1_0"] for c, t in v.items()}
    want = jh.Bottleneck(64, has_downsample=True).apply(sub, jnp.asarray(x))
    with torch.no_grad():
        got = net.layer1[0](_nchw(x))
    _close(_nhwc(got), want)


def test_hrnet_bf16_matches_jax_bf16(setup):
    """dtype=bf16: every conv takes bf16 operands and hands bf16 to an f32
    BatchNorm, layer by layer as flax does. Through some fifty convs a branch the
    two frameworks' bf16 roundings drift apart: 2e-2 of each map's largest
    magnitude, and the maps stay correlated above 0.999."""
    net, v, x = setup
    want = jh.HighResolutionNet("hrnetv2_w18", dtype=jnp.bfloat16).apply(
        _backbone(v), jnp.asarray(x))
    m = th.HighResolutionNet("hrnetv2_w18", dtype=torch.bfloat16).eval()
    m.load_state_dict(net.state_dict())
    with torch.no_grad():
        got = m(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(g), w, atol=2e-2 * np.abs(w).max())
        assert np.corrcoef(_nhwc(g).ravel(), w.ravel())[0, 1] > 0.999


def test_batchnorm_training_follows_flax_conventions():
    """Batch statistics in f32, the running average takes the biased variance;
    `bn_stats_frozen` leaves the running statistics alone."""
    from representationlearning_tpu_torch.models.layers import bn_stats_frozen

    bn = BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0)) * 2 + 1
    out = bn(x.to(torch.bfloat16))
    assert out.dtype == torch.float32
    xf = x.to(torch.bfloat16).float()
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.detach().mean(dim=(0, 2, 3)).numpy(), 0.0, atol=1e-5)
    before = bn.running_mean.clone()
    with bn_stats_frozen(bn):
        bn(x)
    assert torch.equal(bn.running_mean, before) and int(bn.num_batches_tracked) == 1


def test_remat_transformer_gives_the_same_gradients():
    mods = []
    for remat in (False, True):
        m = th.HighResolutionModule(2, (8, 16), num_blocks=1, remat_transformer=remat)
        init_weights(m, torch.Generator().manual_seed(4))
        mods.append(m.train())
    xs = [torch.randn(2, 8, 14, 14), torch.randn(2, 16, 7, 7)]
    grads = []
    for m in mods:
        out = m([x.clone() for x in xs])
        (out[0].square().mean() + out[1].square().mean()).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
