"""Shared pieces of the tests that hold the port's bench RSSFormer workloads
(`representationlearning_tpu_torch/bench.py`: the predict and the six-scale TTA of
`hrnetv2_w18` at 2 x 64 x 64) to the JAX package: the tolerance, the workloads' size,
calmed weights carried across through `convert_rssformer` and back through
`convert/from_jax.py`, and a fixture that refuses the kernel loader. The two workloads
stand in two files, so that the test runner's workers take them side by side."""
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
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
