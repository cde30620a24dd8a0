"""K3's plain version (`varm_propagate_reference`) against the JAX package: the
XLA loop `_propagate` and the Pallas kernel in interpret mode, on the same
numpy-seeded masks and weights (NHWC there, NCHW here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.refine import _propagate
from representationlearning_tpu.ops.pallas.varm import varm_propagate_pallas
from representationlearning_tpu_torch.ops import varm as TV

torch.set_num_threads(2)

# the JAX package's own bound for this kernel (tests/test_pallas_attention.py:59):
# the same products summed in the same order, so in fact the results are equal
ATOL = 1e-6


def _inputs(B, H, W, C, dil, seed=0):
    rng = np.random.default_rng(seed)
    K = 8 * len(dil)
    masks = rng.random((B, H, W, C)).astype(np.float32)
    ref = rng.random((B, H, W, K, 1)).astype(np.float32)
    return masks, ref / ref.sum(3, keepdims=True)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("layout", ["channel_first", "kept_axis"])
@pytest.mark.parametrize("B,H,W,C,dil,num_iter", [
    (2, 16, 16, 5, (1, 2, 4), 3), (1, 12, 20, 1, (1, 2, 4, 8, 12, 24), 3),
    (2, 16, 16, 7, (1, 2), 0), (1, 16, 24, 18, (1, 4), 2)])
def test_varm_reference_matches_jax(B, H, W, C, dil, num_iter, layout):
    masks, ref = _inputs(B, H, W, C, dil)
    ref_cf = _nchw(ref[..., 0])                                   # (B, K, H, W)
    t_ref = ref_cf if layout == "channel_first" else ref_cf[:, :, None]
    got = TV.varm_propagate(_nchw(masks), t_ref, dil, num_iter)
    assert TV.LAUNCHES["varm_propagate"] == 0  # a CPU tensor runs the plain version
    got = got.numpy().transpose(0, 2, 3, 1)
    if num_iter == 0:
        np.testing.assert_array_equal(got, masks)
        return
    want = np.asarray(_propagate(jnp.asarray(masks), jnp.asarray(ref), dil, num_iter))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # C = 5, 7, 1, 18 with channel_block 4: C need not divide the block
    pallas = varm_propagate_pallas(jnp.asarray(masks), jnp.asarray(ref), dil, num_iter,
                                   channel_block=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)


def test_varm_reference_takes_the_pallas_channel_first_weights():
    masks, ref = _inputs(2, 16, 16, 5, (1, 2, 4), seed=3)
    ref_cf = np.ascontiguousarray(ref[..., 0].transpose(0, 3, 1, 2))
    want = varm_propagate_pallas(jnp.asarray(masks), jnp.asarray(ref_cf), (1, 2, 4), 3,
                                 interpret=True)
    got = TV.varm_propagate_reference(_nchw(masks), torch.from_numpy(ref_cf), (1, 2, 4), 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=ATOL)


def test_varm_refuses_weights_of_another_tap_count():
    with pytest.raises(ValueError, match="K = 16"):
        TV.varm_propagate(torch.zeros(1, 2, 8, 8), torch.zeros(1, 8, 8, 8), (1, 2), 1)
    with pytest.raises(ValueError, match=r"\(B, K, 1, H, W\)"):
        TV.varm_propagate(torch.zeros(1, 2, 8, 8), torch.zeros(1, 8, 2, 8, 8), (1,), 1)
