"""PATM (both modes) and WaveBlock of the port (`models/wavemlp.py`) against the JAX
package's, f32, eval and train, on the same numpy inputs and weights (JAX
initialisation, converted by `rml_state_dict_from_jax`). In training both sides
normalise with batch statistics, and the running statistics they leave must
agree too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.wavemlp import PATM as JPATM
from representationlearning_tpu.models.wavemlp import WaveBlock as JWaveBlock
from representationlearning_tpu_torch.convert.from_jax import rml_state_dict_from_jax
from representationlearning_tpu_torch.models.wavemlp import PATM, WaveBlock

torch.set_num_threads(2)
TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(v, rng):
    """Noise on every parameter and statistic, so that zero biases, unit scales
    and unit variances of a fresh initialisation cannot hide a wiring error."""
    def move(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return a * (0.5 + rng.random(a.shape).astype(np.float32))
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, v)


def _pair(jmod, tmod, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    v = _jitter(_np(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x.transpose(0, 2, 3, 1)))),
                rng)
    tmod.load_state_dict(rml_state_dict_from_jax(v))
    return x, v


def _check(jmod, tmod, x, v, train):
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if train and "batch_stats" in v:
        want, mutated = jmod.apply(v, xj, train=True, mutable=["batch_stats"])
    else:
        want, mutated = jmod.apply(v, xj, train=train), None
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())))
    if mutated is not None:   # the running statistics after one training forward
        sd = rml_state_dict_from_jax({"batch_stats": _np(mutated["batch_stats"])})
        ours = tmod.state_dict()
        for k, w in sd.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(ours[k].numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                           err_msg=k)
    return got


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode,dim,hw", [("fc", 8, (6, 9)), ("fc", 20, (1, 1)),
                                         ("conv", 8, (7, 5)), ("conv", 12, (10, 10))])
def test_patm_matches_jax(mode, dim, hw, train):
    j, t = JPATM(dim, mode=mode), PATM(dim, mode=mode)
    x, v = _pair(j, t, (2, dim) + hw, dim)
    names = set(t.state_dict())
    assert {"fc_h.weight", "theta_h_conv.weight", "tfc_h.weight", "reweight.fc1.weight",
            "reweight.fc2.bias", "proj.bias"} <= names
    got = _check(j, t, x, v, train)
    assert got.shape == x.shape


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["fc", "conv"])
def test_waveblock_matches_jax(mode, train):
    j, t = JWaveBlock(16, mode=mode), WaveBlock(16, mode=mode)
    x, v = _pair(j, t, (2, 16, 8, 6), 3)
    assert {"norm1.running_var", "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.bias"} <= \
        set(t.state_dict())
    _check(j, t, x, v, train)


def test_patm_reweight_is_channel_major():
    """(B, 3C) -> (B, C, 3): the three weights of channel c are entries 3c..3c+2 of
    the reweight output. With fc2's bias alone setting them, each branch's share
    is the softmax of its entry in channel c's triple."""
    torch.manual_seed(0)
    t = PATM(4).eval()
    with torch.no_grad():
        t.reweight.fc2.weight.zero_()
        bias = torch.tensor([0.0, 50.0, 0.0] + [50.0, 0.0, 0.0] + [0.0, 0.0, 50.0] * 2)
        t.reweight.fc2.bias.copy_(bias)   # channel 0 -> w, channel 1 -> h, 2 and 3 -> c
        x = torch.randn(1, 4, 5, 5)
        th, tw = t._theta(x, "h"), t._theta(x, "w")
        h = t.tfc_h(torch.cat([t.fc_h(x) * th.cos(), t.fc_h(x) * th.sin()], 1))
        w = t.tfc_w(torch.cat([t.fc_w(x) * tw.cos(), t.fc_w(x) * tw.sin()], 1))
        c = t.fc_c(x)
        want = t.proj(torch.cat([w[:, :1], h[:, 1:2], c[:, 2:]], 1))
        torch.testing.assert_close(t(x), want, rtol=1e-5, atol=1e-5)
