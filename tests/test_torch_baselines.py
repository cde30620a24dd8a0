"""The first half of the baseline zoo (`models/baselines.py`: FarSegV1,
SemanticFPN, PSPNet, FCN8s, AnyUNet, FactSeg, SemanticFPNDecouple) against the
JAX package on the same calmed weights (`zoo_common.calm`) and numpy-seeded
inputs, 2 x 64 x 64, f32, labels with -1 pixels: eval probabilities within 2e-4
of max(1, largest), the training loss dict within 1e-5 relative, the running
statistics after it within 1e-4 of max(largest, 1e-3), and the gradient norm of
each top-level module within 1e-3 relative against `jax.grad` of JAX's training
apply (one jit a model). PSPNet's and FCN8s's dropout is neutralised on both
sides, in the test only: the port's rates at 0, flax's `nn.Dropout` the
identity. Batch 2, not 1: PyTorch's training BatchNorm refuses a channel with
one value, and the pooled 1 x 1 maps have one a sample.
The building blocks are held in test_torch_baselines_blocks.py."""
import numpy as np
import pytest
import torch

import zoo_common as Z

torch.set_num_threads(2)

NAMES = ("FarSegV1", "SemanticFPN", "PSPNet", "FCN8s", "AnyUNet", "FactSeg",
         "SemanticFPNDecouple")


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_jax(name):
    got = Z.model_matches_jax(name)
    heads = {"FactSeg": {"cls_loss", "bi_loss"}, "SemanticFPNDecouple": {"multi_binary"}}
    assert set(got["losses"]) == heads.get(name, {"ce_loss"})
    if name == "SemanticFPNDecouple":   # per-class sigmoids, not a softmax
        assert got["probs"].shape[-1] == Z.CLASSES - 1
        assert not np.allclose(got["probs"].sum(-1), 1.0)
    else:
        np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-5)

