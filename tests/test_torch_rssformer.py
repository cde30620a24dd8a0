"""The RSSFormer predict slice end to end: the port's `HRNetFusion("hrnetv2_w18")`
against the JAX `HRNetFusion` on the same weights (the port's state_dict through
`convert_rssformer`) and the same numpy-seeded 64 x 64 images, with `fused_mlp`
and `fused_attn` on and off; and the converter round trip."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.models.layers import BatchNorm2d
from representationlearning_tpu_torch.models.rssformer import HRNetFusion, SimpleFusion8
from representationlearning_tpu_torch.ops import _build
from representationlearning_tpu_torch.ops import isa_attention as ti
from representationlearning_tpu_torch.ops import mlp_dwbn as tm

torch.set_num_threads(2)

# f32 end to end on probabilities in [0, 1], the bound of tests/test_parity_torch_e2e.py:21
ATOL = 2e-4
# bf16: every conv rounds its operands and its result to bf16 and the two
# frameworks round at the same places but sum in another order, so values drift
# by a few bf16 spacings: 2e-2 of the largest magnitude (probabilities: of 1)
BF16_REL = 2e-2


def _jitter(module, seed):
    """Noise on every bias, norm affine and BatchNorm statistic, so that their
    wiring shows; BatchNorm scales around 0.5, so that the residual stream of
    some forty blocks stays of order 1 at random weights; the classifier's
    fan-out initialisation (std 0.53 over 270 inputs) scaled to logits of order 1,
    so that the softmax is not one-hot and a bf16 spacing of a logit is small."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        module.head[0].weight.mul_(0.1)
        for m in module.modules():
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
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    m = _jitter(HRNetFusion("hrnetv2_w18", 7, generator=torch.Generator().manual_seed(0),
                            device="cpu"), 1)
    sd = m.state_dict()
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), sd, \
        convert_rssformer(state_dict_to_numpy(sd), strict=True)


def _port(sd, **kw):
    m = HRNetFusion("hrnetv2_w18", 7, device="cpu", **kw).eval()
    m.load_state_dict(sd)
    return m


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("fused_mlp,fused_attn", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_rssformer_f32_matches_jax(setup, fused_mlp, fused_attn):
    x, xt, sd, v = setup
    want = np.asarray(JHRNetFusion("hrnetv2_w18", classes=7, fused_mlp=fused_mlp).apply(
        v, jnp.asarray(x)))
    tm.reset_launches()
    ti.reset_launches()
    with torch.no_grad():
        got = _port(sd, fused_mlp=fused_mlp, fused_attn=fused_attn)(xt)
    assert got.shape == (1, 7, 64, 64)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    assert 0.05 < np.asarray(want).std()          # not a constant map
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL)
    assert sum(tm.LAUNCHES.values()) + sum(ti.LAUNCHES.values()) == 0   # CPU: plain versions


@pytest.mark.parametrize("fused", [False, True])
def test_rssformer_bf16_matches_jax_bf16(setup, fused):
    """The predict configuration (dtype=bf16), both forms of the two kernels'
    modules, against the JAX model in bf16."""
    x, xt, sd, v = setup
    want = np.asarray(JHRNetFusion("hrnetv2_w18", classes=7, dtype=jnp.bfloat16,
                                   fused_mlp=fused).apply(v, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = _nhwc(_port(sd, dtype=torch.bfloat16, fused_mlp=fused, fused_attn=fused)(xt))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_REL)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_neck_bf16_matches_jax(setup):
    x, xt, sd, v = setup
    want = np.asarray(JHRNetFusion("hrnetv2_w18", classes=7, neck_bf16=True).apply(
        v, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = _nhwc(_port(sd, neck_bf16=True)(xt))
    np.testing.assert_allclose(got, want, atol=BF16_REL)


def test_converter_round_trip_is_bit_for_bit(setup):
    _, _, sd, v = setup
    back = rssformer_state_dict_from_jax(v)
    assert list(sorted(back)) == list(sorted(sd))
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k
    again = convert_rssformer(state_dict_to_numpy(back), strict=True)
    flat = lambda tree, pre=(): [x for k, t in tree.items() for x in (
        flat(t, pre + (k,)) if isinstance(t, dict) else [(pre + (k,), t)])]
    for (pa, a), (pb, b) in zip(flat(v), flat(again)):
        assert pa == pb and np.array_equal(a, b)
    for name in ("backbone.hrnet.conv1.weight", "backbone.hrnet.stage4.2.transformer.mlp.dw6.bias",
                 "neck.fuse_conv.0.weight", "neck.fuse_conv.1.running_var", "head.0.bias",
                 "headaux.0.weight"):
        assert name in sd


def test_training_mode_returns_the_two_logits(setup):
    _, xt, sd, _ = setup
    m = _port(sd, fused_mlp=True, fused_attn=True).train()
    logit, aux = m(torch.cat([xt, xt.flip(-1)]))
    assert logit.shape == (2, 7, 64, 64) and aux.shape == (2, 7)
    (logit.square().mean() + aux.square().mean()).backward()
    grads = [p.grad for p in m.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert int(m.neck.fuse_conv[1].num_batches_tracked) == 1


def test_device_rule_and_seeded_weights():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HRNetFusion("hrnetv2_w18", 7)
    a, b = (HRNetFusion("hrnetv2_w18", 7, device="cpu",
                        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    a, b = (HRNetFusion("hrt_small", 7, device="cpu",
                        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert type(a.backbone.hrnet).__name__ == "HighResolutionTransformerNet"


def test_cpu_forward_never_touches_the_kernel_loader(setup, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)
    _, xt, sd, _ = setup
    with torch.no_grad():
        out = _port(sd, dtype=torch.bfloat16, fused_mlp=True, fused_attn=True)(xt)
    assert torch.isfinite(out).all()


def test_simple_fusion8_shapes():
    neck = SimpleFusion8(6 + 12).eval()
    fused, x0 = neck([torch.randn(1, 6, 8, 8), torch.randn(1, 12, 4, 4)])
    assert fused.shape == (1, 18, 8, 8) and x0.shape == (1, 6, 8, 8) and fused.min() >= 0
