"""`WeTrBaseline`, `LargeFOV` (`models/tscd.py`), `ConvBNReLU` and `TorchLinear`
(`models/layers.py`) against the JAX package on the same weights and
numpy-seeded inputs. `WeTrBaseline("mit_b0")` at 64 x 64: its state_dict goes to
JAX through `convert/torch2jax.py`'s MiT and SegFormer-head rules and a
classifier rule, strictly (every name consumed), and back through `from_jax` bit
for bit; both return forms within 2e-4 (f32; the bound of
tests/test_parity_torch_e2e.py:21) with the blocks plain and fused (the port's
fused blocks run K1's plain versions on the CPU), and the bf16 fused model within
2e-2 of each output's largest magnitude (tests/test_torch_tscd.py's bf16 bound).
The modules within 2e-5, the BatchNorm statistics after a training forward
included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_common import jitter, nchw, nhwc, scoped_variables
from representationlearning_tpu.convert import torch2jax as T2J
from representationlearning_tpu.models import layers as JL
from representationlearning_tpu.models.tscd import LargeFOV as JLargeFOV
from representationlearning_tpu.models.tscd import WeTrBaseline as JWeTrBaseline
from representationlearning_tpu_torch.convert.from_jax import (state_dict_from_jax,
                                                               wetr_baseline_state_dict_from_jax)
from representationlearning_tpu_torch.models.layers import ConvBNReLU, TorchLinear
from representationlearning_tpu_torch.models.tscd import LargeFOV, WeTrBaseline

torch.set_num_threads(2)

ATOL, BF16_REL, MODULE_TOL = 2e-4, 2e-2, 2e-5


def convert_wetr_baseline(sd, strict=True):
    """The reference's `model_bsl.py` names -> JAX variables: the MiT rules under
    `encoder`, the SegFormer head's, and the classifier's."""
    M = T2J._encoder_scoped_mit_mapper()
    T2J._add_segformer_decoder_rules(M)

    @M.rule(r"classifier\.weight")
    def _cls(m, w):
        return "params", ("classifier", "kernel"), T2J.t_conv(w)

    return M.convert(T2J.state_dict_to_numpy(sd), strict=strict)


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    sd = WeTrBaseline("mit_b0", 21, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    return x, sd, convert_wetr_baseline(sd)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


@pytest.mark.parametrize("fused,pooling", [(False, "gmp"), (True, "gmp"), (False, "gap")])
def test_wetr_baseline_matches_jax(setup, fused, pooling):
    x, sd, v = setup
    jm = JWeTrBaseline("mit_b0", num_classes=21, pooling=pooling, fused_blocks=fused)
    j_cls, j_seg = jm.apply(v, jnp.asarray(x))
    j_cam = jm.apply(v, jnp.asarray(x), cam_only=True)
    port = WeTrBaseline("mit_b0", 21, pooling=pooling, fused_blocks=fused, device="cpu").eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        cls, seg = port(nchw(x))
        cam = port(nchw(x), cam_only=True)
    assert cls.shape == (2, 20) and seg.shape == (2, 21, 16, 16) and cam.shape == (2, 20, 4, 4)
    _close(cls.numpy(), j_cls, ATOL)
    _close(nhwc(seg), j_seg, ATOL)
    _close(nhwc(cam), j_cam, ATOL)


def test_wetr_baseline_fused_bf16_matches_jax_bf16(setup):
    """The configuration that runs K1 on the card: every block fused, bf16."""
    x, sd, v = setup
    j_cls, j_seg = JWeTrBaseline("mit_b0", num_classes=21, fused_blocks=True,
                                 dtype=jnp.bfloat16).apply(v, jnp.asarray(x))
    port = WeTrBaseline("mit_b0", 21, fused_blocks=True, dtype=torch.bfloat16,
                        device="cpu").eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        cls, seg = port(nchw(x))
    for got, want in ((cls.float().numpy(), j_cls), (nhwc(seg), j_seg)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, atol=BF16_REL * np.abs(want).max())


def test_names_consumed_strictly_and_round_trip(setup):
    _, sd, v = setup
    assert {"classifier", "encoder", "decoder"} == set(v["params"])
    assert not any(k.startswith("attn_proj") for k in sd)
    back = wetr_baseline_state_dict_from_jax(v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].shape == t.shape, k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k
    with pytest.raises(KeyError, match="unconverted"):
        convert_wetr_baseline({**sd, "attn_proj.weight": torch.zeros(1, 16, 1, 1)})


def test_large_fov_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 20, 18, 32)).astype(np.float32)
    port = LargeFOV(32, 21, dilation=12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for conv in (port.Conv_0, port.Conv_1, port.Conv_2):
            conv.bias.normal_(0.0, 0.1)
        got = port(nchw(x))
    want = JLargeFOV(21, 12).apply(scoped_variables(port.state_dict()), jnp.asarray(x))
    assert got.shape == (2, 21, 20, 18)
    _close(nhwc(got), want, MODULE_TOL)
    back = state_dict_from_jax(scoped_variables(port.state_dict()), ".".join)
    assert all(torch.equal(back[k], t) for k, t in port.state_dict().items())


@pytest.mark.parametrize("kernel", [(1, 1), (3, 3)])
@pytest.mark.parametrize("use_relu", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_conv_bn_relu_matches_jax(kernel, use_relu, train):
    x = np.random.default_rng(2).standard_normal((2, 9, 7, 8)).astype(np.float32)
    port = jitter(ConvBNReLU(8, 16, kernel, use_relu=use_relu,
                             generator=torch.Generator().manual_seed(2)), 3).train(train)
    v = scoped_variables(port.state_dict())
    jm = JL.ConvBNReLU(16, kernel, use_relu=use_relu)
    if train:
        want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x))
    got = port(nchw(x)).detach()
    _close(nhwc(got), want, MODULE_TOL)
    assert use_relu == bool((got >= 0).all())
    if train:
        now = port.state_dict()
        for k, w in state_dict_from_jax({"batch_stats": mut["batch_stats"]}, ".".join).items():
            if not k.endswith("num_batches_tracked"):
                _close(now[k].numpy(), w.numpy(), MODULE_TOL)
        assert int(port.bn.num_batches_tracked) == 1


def test_torch_linear_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 5, 8)).astype(np.float32)
    port = TorchLinear(8, 16, generator=torch.Generator().manual_seed(4))
    assert float(port.weight.detach().abs().max()) <= 0.04 and not port.bias.any()   # trunc-normal(0.02)
    with torch.no_grad():
        port.bias.normal_()
        got = port(torch.from_numpy(x))
    want = JL.TorchLinear(16).apply({"params": {"Dense_0": {
        "kernel": port.weight.detach().numpy().T, "bias": port.bias.detach().numpy()}}},
        jnp.asarray(x))
    _close(got.numpy(), want, MODULE_TOL)
    assert TorchLinear(8, 4, use_bias=False).bias is None
