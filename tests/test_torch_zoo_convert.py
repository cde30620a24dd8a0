"""The baseline zoo's weights between the packages and its registry entries:
- `convert/from_jax.py::zoo_state_dict_from_jax` inverts the JAX variables of a
  port state_dict (`zoo_common.zoo_variables`: `convert_resnet50` /
  `convert_hrnet` on the encoders, JAX's scopes elsewhere, flax's scalar PReLU
  slope) bit for bit, for each of the fourteen;
- `cli/convert_checkpoint.py --from-jax --family <name>` turns JAX variables
  drawn over the shapes of the JAX model's `init` (as
  tests/test_torch_cli_convert_checkpoint.py does) into a state_dict that loads
  strictly into the port's model, value for value where a leaf keeps its layout
  (PAN's at 128 x 128, where its FPA has all three levels)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_common as Z
from representationlearning_tpu_torch.cli import convert_checkpoint as CC
from representationlearning_tpu_torch.convert.from_jax import zoo_state_dict_from_jax
from representationlearning_tpu_torch.models.smp_zoo import ZOO_MODELS

torch.set_num_threads(2)


def test_zoo_names():
    assert set(ZOO_MODELS) == set(Z.ZOO)


@pytest.mark.parametrize("name", sorted(Z.ZOO))
def test_from_jax_round_trip(name):
    sd = Z.calm(Z.port_model(name), 2).state_dict()
    back = zoo_state_dict_from_jax(Z.zoo_variables(sd))
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        assert torch.equal(back[k], t), k
    Z.port_model(name).load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", sorted(Z.ZOO))
def test_cli_from_jax_family(name, tmp_path):
    side = 128 if name == "PAN" else 64
    shapes = jax.eval_shape(lambda: Z.jax_model(name).init(jax.random.PRNGKey(0),
                                                            jnp.zeros((1, side, side, 3))))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    src, dst = tmp_path / "v.npy", tmp_path / "o.pt"
    np.save(src, v, allow_pickle=True)
    try:
        out = CC.main(["--from-jax", "--family", name, "--src", str(src), "--dst", str(dst)])
        saved = sorted(torch.load(dst, weights_only=True))
    finally:   # full-width weights: 0.1-0.5 GB a model, not kept with the test's folder
        src.unlink()
        dst.unlink(missing_ok=True)
    model = Z.port_model(name)
    model.load_state_dict(out, strict=True)
    assert saved == sorted(out)
    flat = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(v)]
    same = {k: t for k, t in model.state_dict().items()
            if t.ndim == 1 and not k.endswith("num_batches_tracked")}
    assert same and all(any(a.size == t.numel() and np.array_equal(a.reshape(t.shape), t.numpy())
                            for a in flat) for t in same.values())   # PReLU's () as (1,)

