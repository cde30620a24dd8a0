"""LinkNet, DeepLabV3Plus and PAN of the baseline zoo (`models/smp_zoo.py`)
against the JAX package on the same calmed weights and numpy-seeded inputs, 2 x
64 x 64, labels with -1 pixels: eval probabilities in f32 within 2e-4 of max(1,
largest); the training loss dict within 1e-5 relative, the running statistics
after it within 1e-4 of max(largest, 1e-3) and the gradient norm of each
top-level module within 1e-3 relative against `jax.grad` of JAX's training
apply, these in f64 on both sides (JAX under `jax.enable_x64`, the port after
`.double()`; one jit each way).

Their gradients pass BatchNorms over a 1 x 1 map of two images (ASPP's and
FPA's pooled branches, PAN's gates), whose input gradient is 0 in exact
arithmetic and in floating point rounding noise over the batch's spread, and
flax's one-pass variance adds its own: JAX's f32 gradient norms are off its f64
ones by up to 1.9e-3 (LinkNet), 1.3e-3 (DeepLabV3Plus) and 19% (PAN, whose f32
loss is also 1e-4 off), farther than the bound, while the port's f32 ones are
within 1.8e-3 of JAX's f64 (measured at these seeds)."""
import pytest
import torch

import zoo_common as Z

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ("LinkNet", "DeepLabV3Plus", "PAN"))
def test_model_matches_jax(name):
    Z.model_matches_jax(name, f64_train=True)
