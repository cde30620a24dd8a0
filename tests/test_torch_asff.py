"""The ASFF variants (`models/asff.py`) against the JAX package on the same
weights and numpy-seeded inputs, f32: `ASFF` and `SelfAttn` as modules (2e-5,
one module's bound), `rsNetFusion` and `HRNetFusion2` at `hrnetv2_w18`, 64 x 64
(probabilities within 2e-4, the bound of tests/test_parity_torch_e2e.py:21), the
CGFL loss on the port's training logits against the loss dict JAX's training
call returns (1e-5 relative), and the `from_jax` round trip. The HRNet backbone
goes to JAX through `convert_hrnet`; the rest is named after JAX's scopes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_common import jitter, nchw, nhwc, scoped_variables
from representationlearning_tpu.convert.torch2jax import convert_hrnet, state_dict_to_numpy
from representationlearning_tpu.models import asff as JA
from representationlearning_tpu_torch.convert.from_jax import (hrnet_fusion2_state_dict_from_jax,
                                                               rsnet_fusion_state_dict_from_jax)
from representationlearning_tpu_torch.core.registry import MODELS
from representationlearning_tpu_torch.losses.cgfl import segmentation_loss
from representationlearning_tpu_torch.models import asff as TA

torch.set_num_threads(2)

ATOL, MODULE_TOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5
B, SIDE, CLASSES = 1, 64, 7
WIDTHS = (18, 36, 72, 144)
LOSS_CONFIG = {"ce": {}}
MODELS_UNDER_TEST = {"rsNetFusion": (TA.RsNetFusion, JA.RsNetFusion,
                                     rsnet_fusion_state_dict_from_jax),
                     "HRNetFusion2": (TA.HRNetFusion2, JA.HRNetFusion2,
                                      hrnet_fusion2_state_dict_from_jax)}


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def _variables(sd):
    """The backbone through `convert_hrnet` (strict), the rest by JAX's scopes."""
    v = scoped_variables({k: t for k, t in sd.items() if not k.startswith("backbone.")})
    enc = convert_hrnet(state_dict_to_numpy({k: t for k, t in sd.items()
                                             if k.startswith("backbone.")}),
                        strict=True, prefix="backbone.")
    for coll in ("params", "batch_stats"):
        v.setdefault(coll, {}).update(enc.get(coll, {}))
    return v


def _feats(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 16 >> i, 16 >> i, c)).astype(np.float32)
            for i, c in enumerate(WIDTHS)]


def test_asff_matches_jax():
    port = TA.ASFF(WIDTHS).eval()
    feats = _feats(0)
    want = JA.ASFF().apply(scoped_variables(port.state_dict()), [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    assert got.shape == (2, sum(WIDTHS), 16, 16)
    _close(nhwc(got), np.asarray(want), MODULE_TOL)


def test_self_attn_matches_jax():
    port = TA.SelfAttn(32).eval()
    with torch.no_grad():
        port.gamma.fill_(0.7)    # zero at first: the attention would not show
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 32)).astype(np.float32)
    want = JA.SelfAttn(32).apply(scoped_variables(port.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    _close(nhwc(got), np.asarray(want), MODULE_TOL)
    assert float(TA.SelfAttn(32).gamma.detach()) == 0.0


@pytest.fixture(scope="module", params=sorted(MODELS_UNDER_TEST))
def model_case(request):
    """One JAX jit a model: the eval probabilities and the training loss dict."""
    name = request.param
    port_cls, jax_cls, from_jax = MODELS_UNDER_TEST[name]
    sd = jitter(port_cls("hrnetv2_w18", CLASSES, device="cpu",
                         generator=torch.Generator().manual_seed(0)), 2).state_dict()
    v = _variables(sd)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.integers(-1, CLASSES, (B, SIDE, SIDE)).astype(np.int32)
    model = jax_cls("hrnetv2_w18", classes=CLASSES, loss_config=LOSS_CONFIG)

    @jax.jit
    def run(v, x, y):
        losses, _ = model.apply(v, x, y, train=True, mutable=["batch_stats"])
        return model.apply(v, x), losses

    probs, losses = run(v, jnp.asarray(x), jnp.asarray(y))
    return (name, port_cls, from_jax, sd, v, x, y, np.asarray(probs),
            {k: float(l) for k, l in losses.items()})


def _port(case):
    name, port_cls, _, sd, *_ = case
    m = port_cls("hrnetv2_w18", CLASSES, loss_config=LOSS_CONFIG, device="cpu")
    m.load_state_dict(sd)
    assert MODELS.get(name) is port_cls
    return m


def test_eval_matches_jax(model_case):
    x, want = model_case[5], model_case[7]
    with torch.no_grad():
        got = _port(model_case).eval()(nchw(x))
    assert got.shape == (B, CLASSES, SIDE, SIDE)
    assert 0.05 < want.std()      # not a constant map
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)


def test_training_logits_give_jax_loss(model_case):
    """Training mode returns the logits; the CGFL loss on them, with the model's
    `loss_config` and `ignore_index`, is the dict JAX's training call returns."""
    x, y, want = model_case[5], model_case[6], model_case[8]
    m = _port(model_case).train()
    logit = m(nchw(x))
    assert logit.shape == (B, CLASSES, SIDE, SIDE)
    losses = segmentation_loss(logit, torch.from_numpy(y).long(), m.loss_config, m.ignore_index)
    assert set(losses) == set(want)
    for k, w in want.items():
        assert abs(float(losses[k].detach()) - w) <= LOSS_RTOL * abs(w), (k, w)
    sum(losses.values()).backward()
    assert all(p.grad is not None for p in m.parameters())


def test_from_jax_round_trip(model_case):
    _, port_cls, from_jax, sd, v, *_ = model_case
    back = from_jax(v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k
    port_cls("hrnetv2_w18", CLASSES, device="cpu").load_state_dict(back, strict=True)
