"""DRFL's train step of the PyTorch port against the JAX package's
`make_drfl_train_step` in f64, gradient by gradient: the f32 step is
ill-conditioned at random weights (`tests/test_torch_train_drfl.py`), so the
per-tensor check runs both sides in float64, JAX under `jax.enable_x64` with
its variables cast, the port after `.double()`. JAX's attention einsums ask for
f32 results (`preferred_element_type`, `models/dcl.py:191,194`), so its two
attention products stay f32 and the sides agree to f32 rounding there, not to
f64's: every parameter's gradient within 1e-6 of its tensor's largest entry
(measured 2.0e-7, at the transformers' query weights); the key biases', 0 in
exact arithmetic (a bias added to every key shifts each row of scores by a
constant, which the softmax ignores), within 1e-6 of the query weights' largest
gradient on both sides; the three losses within 1e-8 relative (measured 9e-12);
the running statistics within 1e-8 (measured 5.0e-10). Same model, batch, key
and mask feed as the f32 file; the masks are those JAX draws under x64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import dcl as JD
from representationlearning_tpu_torch.convert.from_jax import dcl_state_dict_from_jax
from representationlearning_tpu_torch.models import dcl as TD
from representationlearning_tpu_torch.train import drfl as TT
from test_torch_dcl import draw_variables
from test_torch_train_drfl import LAYERS, SIDE, batch_and_key, feed, jax_reference

torch.set_num_threads(2)

GRAD_REL = 1e-6
ZERO_REL = 1e-6
LOSS_REL = 1e-8
STATS = 1e-8


@pytest.fixture(scope="module")
def steps():
    model = JD.Softnet(3, LAYERS)
    v = draw_variables(model, (jnp.zeros((1, SIDE, SIDE, 3)),), 0)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    batch, key = batch_and_key()
    batch = {k: (np.asarray(x, np.float64) if k != "name" else x) for k, x in batch.items()}
    with jax.enable_x64(True):
        want = jax_reference(model, v, batch, key)
    assert jax.tree_util.tree_leaves(want["grads"])[0].dtype == np.float64

    port = TD.Softnet(3, LAYERS, SIDE, device="cpu").double()
    port.load_state_dict(dcl_state_dict_from_jax(v), strict=True)
    port.train()
    with pytest.MonkeyPatch.context() as mp:
        left = feed(mp, want["masks"])
        total, parts = TT.drfl_losses(port, {k: torch.from_numpy(np.array(batch[k]))
                                             .permute(0, 3, 1, 2).contiguous() for k in "ABC"})
        total.backward()
    assert next(left, None) is None
    got = {k: float(x.detach()) for k, x in parts.items()}
    got["total"] = float(total.detach())
    return dict(want=want, port=port, metrics=got)


def test_losses_match_jax_in_f64(steps):
    want = steps["want"]["metrics"]
    assert steps["metrics"].keys() == want.keys()
    for k, w in want.items():
        assert steps["metrics"][k] == pytest.approx(w, rel=LOSS_REL), k


def test_every_gradient_matches_jax_in_f64(steps):
    want = dcl_state_dict_from_jax({"params": steps["want"]["grads"]})
    port = dict(steps["port"].named_parameters())
    assert want.keys() == port.keys()
    for k, p in port.items():
        g, w = p.grad, want[k]
        assert g.dtype == w.dtype == torch.float64, k
        if k.endswith("key.bias"):
            scale = float(want[k.replace("key.bias", "query.weight")].abs().max())
            assert max(float(g.abs().max()), float(w.abs().max())) <= ZERO_REL * scale, k
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_REL * float(w.abs().max()), msg=k)


def test_running_statistics_match_jax_in_f64(steps):
    want = dcl_state_dict_from_jax({"batch_stats": steps["want"]["batch_stats"]})
    sd = steps["port"].state_dict()
    for k, w in want.items():
        if "running" in k:
            torch.testing.assert_close(sd[k], w, rtol=0, atol=STATS, msg=k)
