"""`tscd_state_dict_from_jax` is the exact inverse of `convert_tscd`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_tscd, state_dict_to_numpy
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu_torch.convert.from_jax import (state_dict_from_jax,
                                                             tscd_state_dict_from_jax)
from representationlearning_tpu_torch.models.tscd import TSCD

torch.set_num_threads(2)


def test_jax_init_loads_strictly_into_the_port():
    """JAX `TSCD.init` variables -> `tscd_state_dict_from_jax` ->
    `load_state_dict(strict=True)`: every name and shape lines up."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=21).init)(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(np.asarray, v)
    sd = tscd_state_dict_from_jax(v)
    m = TSCD("mit_b0", 21, fused_blocks=True, device="cpu")
    m.load_state_dict(sd, strict=True)
    q = v["params"]["encoder"]["block2_1"]["attn"]["q"]["kernel"]
    assert torch.equal(m.encoder.block2[1].attn.q.weight, torch.from_numpy(q.T.copy()))
    assert int(m.decoder.linear_fuse.bn.num_batches_tracked) == 0


@pytest.mark.parametrize("backbone,fused", [("mit_b0", True), ("mit_b0", False),
                                            ("mit_b1", True)])
def test_roundtrip_through_convert_tscd_is_bit_exact(backbone, fused):
    """port state_dict -> `convert_tscd` -> `tscd_state_dict_from_jax` returns
    the same names, dtypes and bits (trained-looking BN stats included)."""
    g = torch.Generator().manual_seed(1)
    m = TSCD(backbone, 21, fused_blocks=fused, generator=g, device="cpu")
    bn = m.decoder.linear_fuse.bn
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=g))
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.5)
    sd = m.state_dict()
    back = tscd_state_dict_from_jax(convert_tscd(state_dict_to_numpy(sd)))
    assert list(sorted(back)) == list(sorted(sd))
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def test_unknown_leaves_are_rejected():
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {"x": {"gamma": np.zeros(3)}}})
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {}, "cache": {}})
