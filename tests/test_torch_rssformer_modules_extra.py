"""The seven `rssformer_modules` classes that no model uses yet
(`DALMultiheadAttention`, `Mlp`, `MlpDW`, `MultiheadAttention2`, `MlpLight`,
`MlpConvBN`, `dilated_conv`) against the JAX package's on the same weights (the
port's parameters, named after JAX's scopes, carried over) and numpy-seeded
inputs, f32, within 2e-5 of max(1, the largest magnitude): the relative-position
bias's indexing, `residual_attn`, and BatchNorm1d's running statistics after a
training forward (flax's momentum and biased variance), as
tests/test_inventory_extras.py:105-130 runs the JAX modules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_common import jitter, nchw, nhwc, scoped_variables
from representationlearning_tpu.models import rssformer_modules as JM
from representationlearning_tpu_torch.convert.from_jax import state_dict_from_jax
from representationlearning_tpu_torch.models import rssformer_modules as TM

torch.set_num_threads(2)

TOL = 2e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _round_trip(port):
    """The port's names are JAX's scopes: `from_jax` carries the variables back
    (the RPE table, a leaf of its own name, as it is)."""
    v = scoped_variables(port.state_dict())
    back = {}
    if "relative_position_bias_table" in v["params"]:
        back["relative_position_bias_table"] = torch.from_numpy(
            v["params"].pop("relative_position_bias_table"))
    back.update(state_dict_from_jax(v, ".".join))
    want = {k: t for k, t in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(k for k in back if not k.endswith("num_batches_tracked")) == sorted(want)
    assert all(torch.equal(back[k], t) for k, t in want.items())


@pytest.mark.parametrize("rpe", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_dal_multihead_attention_matches_jax(rpe, residual):
    ws, C, nh = 3, 16, 4
    port = TM.DALMultiheadAttention(C, nh, rpe=rpe, window_size=ws).eval()
    if rpe:   # trunc-normal(0.02) at first: make the bias show
        with torch.no_grad():
            port.relative_position_bias_table.copy_(torch.from_numpy(_rand(1, 25, nh)))
    x = _rand(2, 2, ws * ws, C)
    res = _rand(3, 2, nh, ws * ws, ws * ws) if residual else None
    out, logits = JM.DALMultiheadAttention(C, nh, rpe=rpe, window_size=ws).apply(
        scoped_variables(port.state_dict()), jnp.asarray(x),
        None if res is None else jnp.asarray(res))
    with torch.no_grad():
        got, got_logits = port(torch.from_numpy(x), None if res is None else torch.from_numpy(res))
    _close(got.numpy(), out)
    _close(got_logits.numpy(), logits)
    _round_trip(port)


def test_relative_position_index():
    """The bias of head h between window tokens s = (i, j) and t = (k, l) is
    table[(i - k + ws - 1) (2 ws - 1) + (j - l + ws - 1), h]."""
    ws, nh = 3, 2
    port = TM.DALMultiheadAttention(8, nh, rpe=True, window_size=ws)
    with torch.no_grad():
        port.relative_position_bias_table.copy_(torch.arange(25 * nh, dtype=torch.float32)
                                                .reshape(25, nh))
        bias = port._position_bias()
    for s in range(ws * ws):
        for t in range(ws * ws):
            (i, j), (k, l) = divmod(s, ws), divmod(t, ws)
            idx = (i - k + ws - 1) * (2 * ws - 1) + (j - l + ws - 1)
            assert bias[:, s, t].tolist() == port.relative_position_bias_table[idx].tolist()
    with pytest.raises(ValueError, match="rpe needs window tokens"):
        port(torch.zeros(1, 8, 8))


def test_mlp_and_mlp_light_match_jax():
    x = _rand(4, 2, 16, 8)
    port = TM.Mlp(8, 32, 12).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), JM.Mlp(32, 12).apply(scoped_variables(port.state_dict()), jnp.asarray(x)))
    light = TM.MlpLight(8).eval()
    with torch.no_grad():
        got = light(torch.from_numpy(x))
    _close(got.numpy(), JM.MlpLight().apply(scoped_variables(light.state_dict()), jnp.asarray(x)))
    _round_trip(port)
    _round_trip(light)


def test_mlp_dw_matches_jax():
    H, W = 4, 5
    x = _rand(5, 2, H * W, 8)
    port = TM.MlpDW(8, 32, 8).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x), H, W)
    _close(got.numpy(), JM.MlpDW(32, 8).apply(scoped_variables(port.state_dict()),
                                              jnp.asarray(x), H, W))
    _round_trip(port)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("use_bias", [True, False])
def test_multihead_attention2_matches_jax(residual, use_bias):
    C, nh, S, T = 16, 4, 9, 5
    port = TM.MultiheadAttention2(C, nh, use_bias=use_bias).eval()
    q, k, v = _rand(6, 2, S, C), _rand(7, 2, T, C), _rand(8, 2, T, C)
    res = _rand(9, 2, nh, S, T) if residual else None
    want = JM.MultiheadAttention2(C, nh, use_bias=use_bias).apply(
        scoped_variables(port.state_dict()), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if res is None else jnp.asarray(res))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (q, k, v)),
                   None if res is None else torch.from_numpy(res))
    _close(got.numpy(), want)
    _round_trip(port)


@pytest.mark.parametrize("train", [False, True])
def test_mlp_conv_bn_matches_jax(train):
    """BatchNorm1d over (B, N): in training the batch statistics and the running
    ones after the step (flax momentum 0.9, biased variance)."""
    x = _rand(10, 2, 12, 8)
    port = jitter(TM.MlpConvBN(8, 16, 8), 11).train(train)
    v = scoped_variables(port.state_dict())
    jm = JM.MlpConvBN(16, 8)
    if train:
        want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x))
    got = port(torch.from_numpy(x)).detach()
    _close(got.numpy(), want)
    if train:
        stats = state_dict_from_jax({"batch_stats": mut["batch_stats"]}, ".".join)
        now = port.state_dict()
        for k, w in stats.items():
            if not k.endswith("num_batches_tracked"):
                _close(now[k].numpy(), w.numpy())
                bn, leaf = k.split(".")
                before = v["batch_stats"][bn][leaf.removeprefix("running_")]
                assert not np.allclose(now[k].numpy(), before), k   # moved by the step
    _round_trip(port)


@pytest.mark.parametrize("k,d,stride", [(3, 1, 1), (3, 2, 1), (5, 3, 2), (1, 1, 1)])
def test_dilated_conv_matches_jax(k, d, stride):
    x = _rand(12, 2, 13, 11, 6)
    port = TM.dilated_conv(6, 10, k, d, stride)
    assert port.bias is None
    want = JM.dilated_conv(10, k, d, stride).apply(
        {"params": {"kernel": port.weight.detach().numpy().transpose(2, 3, 1, 0)}}, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    _close(nhwc(got), want)
