"""The RSSFormer trainer (`train/rssformer.py`) on the baseline zoo:
- one `make_rssformer_train_step` of the port against JAX's on
  `AnyUNet(base=8, depth=3)` (no ResNet, so JAX's jit compiles quickly), 2 x 64 x
  64, from the same calmed weights: the losses within 1e-5 relative, every
  parameter after the step within 1e-5 of its tensor's largest entry, the
  running statistics within 1e-4 of max(largest, 1e-3);
- `evaluate` on the same model against JAX's `evaluate` on two batches, the
  scores within 1e-6;
- PSPNet's and FCN8s's dropout draws from the step's generator, at 0.3 then
  0.15 three times, and 0.1;
- every zoo model through the step and `evaluate` on the CPU: finite losses,
  each trained BatchNorm's running statistics moved once, the ResNet-50's
  frozen ones not, probabilities (SemanticFPNDecouple: sigmoids) in [0, 1];
- `HRNetFusion` keeps its own path (tests/test_torch_train_rssformer.py holds
  it to JAX);
- `MODELS.build(name, classes=7, device="cpu")` gives each zoo model with
  seeded, repeatable weights, and `device=None` raises where there is no card."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_common as Z
from representationlearning_tpu.models import baselines as JB
from representationlearning_tpu.train import rssformer as JRS
from representationlearning_tpu_torch.convert.from_jax import zoo_state_dict_from_jax
from representationlearning_tpu_torch.core.registry import MODELS
from representationlearning_tpu_torch.models import baselines as TB
from representationlearning_tpu_torch.models.layers import BatchNorm2d
from representationlearning_tpu_torch.models.resnet import FrozenBatchNorm
from representationlearning_tpu_torch.train import rssformer as TRS

torch.set_num_threads(2)

PARAM_RTOL, STATS_TOL, LOSS_RTOL, SCORE_TOL = 1e-5, 1e-4, 1e-5, 1e-6
CFG = TRS.RSSFormerTrainConfig()


def _unet():
    m = TB.AnyUNet(Z.CLASSES, base=8, depth=3, loss_config={"ce": {}}, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    return Z.calm(m, 6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_step_matches_jax():
    port = _unet()
    v = Z.zoo_variables(port.state_dict())
    x, y = Z.inputs(7, batch=2)
    model = JB.AnyUNet(Z.CLASSES, base=8, depth=3, loss_config={"ce": {}})
    # create_rssformer_state reads init and apply: init hands over the port's weights
    state = JRS.create_rssformer_state(SimpleNamespace(init=lambda *a: v, apply=model.apply),
                                       (64, 64, 3), CFG)
    new, met = JRS.make_rssformer_train_step(model, CFG)(
        state, {"image": jnp.asarray(x), "mask": jnp.asarray(y)}, jax.random.PRNGKey(0))
    want = zoo_state_dict_from_jax({"params": _np(new.params),
                                    "batch_stats": _np(new.batch_stats)})
    tstate = TRS.create_rssformer_state(port, CFG)
    tstate, tmet = TRS.make_rssformer_train_step(port, CFG, device="cpu")(
        tstate, {"image": Z.nchw(x), "mask": torch.from_numpy(y).long()},
        torch.Generator().manual_seed(0))
    assert set(tmet) == {"ce_loss", "total"} and tstate.step == 1
    for k, w in met.items():
        assert abs(float(tmet[k]) - float(w)) <= LOSS_RTOL * abs(float(w)), k
    got = port.state_dict()
    params = dict(port.named_parameters())
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((got[k] - w).abs().max())
        if k in params:
            assert err <= PARAM_RTOL * float(w.abs().max()), (k, err)
        else:
            assert err <= STATS_TOL * max(float(w.abs().max()), 1e-3), (k, err)


def test_evaluate_matches_jax():
    """The head scaled by 20, so that no pixel's two best classes are within
    f32 rounding of each other (at the calmed weights a few pixels of 8192 are,
    and their argmax may go either way)."""
    port = _unet()
    with torch.no_grad():
        port.head.weight.mul_(20.0)
    v = Z.zoo_variables(port.state_dict())
    model = JB.AnyUNet(Z.CLASSES, base=8, depth=3)
    batches = [Z.inputs(s, batch=2) for s in (8, 9)]
    want = JRS.evaluate(model, v, [(jnp.asarray(x), y) for x, y in batches], Z.CLASSES)
    got = TRS.evaluate(port, [(Z.nchw(x), torch.from_numpy(y).long()) for x, y in batches],
                       Z.CLASSES, device="cpu")
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = (list(got[k].values()), list(w.values())) if k == "iou" else (got[k], w)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=SCORE_TOL, err_msg=k)
    assert 0.0 < got["miou"] < 1.0


@pytest.mark.parametrize("name,rates", [("PSPNet", [0.3, 0.15, 0.15, 0.15]),
                                        ("FCN8s", [0.1])])
def test_dropout_draws_from_the_step_generator(name, rates, monkeypatch):
    seen = []
    plain = TB.dropout

    def record(x, rate, training, generator=None):
        seen.append((rate, training, generator))
        return plain(x, rate, training, generator)

    monkeypatch.setattr(TB, "dropout", record)
    x, y = Z.inputs(10, batch=2)
    batch = {"image": Z.nchw(x), "mask": torch.from_numpy(y).long()}
    totals = []
    for seed in (0, 0, 1):
        m = Z.port_model(name)
        gen = torch.Generator().manual_seed(seed)
        seen.clear()
        _, met = TRS.make_rssformer_train_step(m, CFG, device="cpu")(
            TRS.create_rssformer_state(m, CFG), batch, gen)
        assert [r for r, _, _ in seen] == rates
        assert all(t and g is gen for _, t, g in seen)
        totals.append(float(met["total"]))
    assert totals[0] == totals[1] != totals[2]
    with torch.no_grad():   # eval: no dropout
        seen.clear()
        m.eval()(batch["image"])
    assert [r for r, _, _ in seen] == rates and not any(t for _, t, _ in seen)


@pytest.mark.parametrize("name", sorted(Z.ZOO))
def test_every_zoo_model_trains_and_evaluates(name):
    m = Z.port_model(name)
    x, y = Z.inputs(11, batch=2)
    frozen = {k: b.clone() for k, b in m.named_buffers() if "running" in k}
    trained = [n for n, mod in m.named_modules() if isinstance(mod, BatchNorm2d)]
    _, met = TRS.make_rssformer_train_step(m, CFG, device="cpu")(
        TRS.create_rssformer_state(m, CFG),
        {"image": Z.nchw(x), "mask": torch.from_numpy(y).long()},
        torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in met.values())
    for n, mod in m.named_modules():
        if isinstance(mod, BatchNorm2d):
            moved = not torch.equal(mod.running_mean, frozen[f"{n}.running_mean"])
            unused = name == "PAN" and n in ("fpa.d3.bn", "fpa.u3.bn")   # 4 x 4: two levels
            assert int(mod.num_batches_tracked) == (0 if unused else 1) and moved != unused, n
        elif isinstance(mod, FrozenBatchNorm):
            assert torch.equal(mod.running_mean, frozen[f"{n}.running_mean"]), n
    assert trained
    scores = TRS.evaluate(m, [(Z.nchw(x), torch.from_numpy(y).long())], Z.CLASSES,
                          device="cpu")
    assert 0.0 <= scores["miou"] <= 1.0
    with torch.no_grad():
        p = m.eval()(Z.nchw(x))
    assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0


@pytest.mark.parametrize("name", sorted(Z.ZOO))
def test_build_seeded_on_the_cpu_and_card_by_default(name):
    kw = {"hrnet_type": "hrnetv2_w18"} if name == "trans" else {}
    a, b = (MODELS.build(name, classes=7, device="cpu", generator=torch.Generator().manual_seed(4),
                         **kw) for _ in range(2))
    assert all(p.device.type == "cpu" for p in a.parameters())
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    c = MODELS.build(name, classes=7, device="cpu", generator=torch.Generator().manual_seed(5),
                     **kw)
    assert not all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                     c.state_dict().values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MODELS.build(name, classes=7, **kw)


def test_losses_refuse_a_model_outside_the_zoo():
    """`rssformer_losses` takes an HRNetFusion or a zoo model, and names any other."""
    batch = {"image": torch.zeros(1, 3, 8, 8), "mask": torch.zeros(1, 8, 8, dtype=torch.long)}
    with pytest.raises(TypeError, match="Conv2d"):
        TRS.rssformer_losses(torch.nn.Conv2d(3, 7, 1), batch)
