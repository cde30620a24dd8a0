"""`trans` of the baseline zoo (`models/smp_zoo.py::Trans`: the HRNet without
the transformer fusion, the align-corners upsample-concat, `fuse_conv` with
bias, `fuse_bn`, ReLU, the head and the x4 align-corners upsample) at
`hrnetv2_w18` against the JAX package on the same calmed weights, 2 x 64 x 64,
f32, labels with -1 pixels: eval probabilities within 2e-4 of max(1, largest),
the training loss dict within 1e-5 relative, the running statistics after it
within 1e-4 of max(largest, 1e-3), each top-level module's gradient norm within
1e-3 relative against `jax.grad` of JAX's training apply. JAX runs eagerly: a
jit of the HRNet's forward and gradient compiles for longer than the eager run
takes (91 s against 75 s on a CPU)."""
import numpy as np
import torch

import zoo_common as Z
from representationlearning_tpu_torch.models.hrnet import HighResolutionNet

torch.set_num_threads(2)


def test_trans_matches_jax():
    got = Z.model_matches_jax("trans", jit=False)
    assert set(got["norms"]) == {"backbone", "fuse_conv", "fuse_bn", "head"}
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-5)


def test_trans_defaults():
    """JAX's defaults: hrnetv2_w48 (720 fused channels), 7 classes, x4."""
    m = Z.TZ.Trans(device="cpu")
    assert isinstance(m.backbone, HighResolutionNet) and m.upsample_scale == 4
    assert m.fuse_conv.weight.shape == (720, 720, 1, 1) and m.fuse_conv.bias is not None
    assert m.head.weight.shape == (7, 720, 1, 1)
    assert not any(".transformer." in k for k in m.state_dict())
