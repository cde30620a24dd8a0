"""The port's bench entry point (`representationlearning_tpu_torch/bench.py`) on the
CPU, its two RSSFormer workloads: the predict and the six-scale TTA of
`hrnetv2_w18` at 2 x 64 x 64 against the JAX package on the same weights (a
calmed model's, through `convert_rssformer` and back through
`convert/from_jax.py`) and the same numpy draws, f32. Six eager JAX forwards make
the TTA case the slowest of the bench's tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
from representationlearning_tpu.infer.tta import default_tta_config as j_tta_config
from representationlearning_tpu.infer.tta import tta as j_tta
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu_torch import bench as TB
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.models.layers import BatchNorm2d
from representationlearning_tpu_torch.ops import _build

torch.set_num_threads(2)

ATOL = 2e-4       # f32 end to end, the bound of tests/test_parity_torch_e2e.py:21
SMALL_HRNET = dict(hrnet_type="hrnetv2_w18", side=64, batch=2, dtype=torch.float32)


@pytest.fixture
def no_kernels(monkeypatch):
    """On CPU tensors every wrapper runs its plain version: the loader is never asked."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _calm(module, seed):
    """Random RSSFormer weights that can be compared: BatchNorm scales halved and
    the classifier scaled by 0.1 (or the softmax is one-hot), noise on every bias,
    norm affine and BatchNorm statistic (so their wiring shows)."""
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
def hrnet_weights():
    """JAX variables of a calmed `hrnetv2_w18`, and the port's state_dict converted
    back from them."""
    w = TB.build_rssformer_tta_eval("cpu", **SMALL_HRNET)
    v = convert_rssformer(state_dict_to_numpy(_calm(w.model, 1).state_dict()), strict=True)
    return v, rssformer_state_dict_from_jax(v)


def test_rssformer_predict_matches_jax(hrnet_weights, no_kernels):
    """Probabilities and their mean of the K5 model (plain K5 on the CPU) against
    the JAX model without the fused FFN; the unfused twin holds the same weights."""
    v, sd = hrnet_weights
    w = TB.build_rssformer_predict("cpu", **SMALL_HRNET)
    w.model.load_state_dict(sd)
    assert all(m.fused for m in w.model.modules() if type(m).__name__ == "MlpDWBN")
    want = np.asarray(JHRNetFusion("hrnetv2_w18", classes=7).apply(v, jnp.asarray(w.inputs["x"])))
    prob = w.run()
    assert prob.shape == (2, 7, 64, 64) and prob.std() > 0.01   # not one-hot
    np.testing.assert_allclose(prob.numpy(), _nchw(want), rtol=0, atol=ATOL)
    assert abs(float(w.call()) - float(want.mean())) <= ATOL
    assert abs(float(w.count()) - float(w.call())) <= 1e-5


def test_rssformer_tta_eval_matches_jax(hrnet_weights, no_kernels):
    """The averaged probabilities of the six scales, before the argmax."""
    v, sd = hrnet_weights
    w = TB.build_rssformer_tta_eval("cpu", **SMALL_HRNET)
    w.model.load_state_dict(sd)
    model = JHRNetFusion("hrnetv2_w18", classes=7)
    want = np.asarray(j_tta(lambda im: model.apply(v, im), jnp.asarray(w.inputs["x"]),
                            j_tta_config()))
    pred = w.run()
    assert pred.shape == (2, 7, 64, 64)
    np.testing.assert_allclose(pred.numpy(), _nchw(want), rtol=0, atol=ATOL)
    assert float(w.call()) == float(pred.argmax(1).sum())
