"""The RSSFormer train step as a whole: one `make_rssformer_train_step` call of the
port against the JAX trainer (`train/rssformer.py:42-81`), on
`HRNetFusion("hrnetv2_w18", 7, loss_config={"ce": {}})` at 2 x 64 x 64, f32, with
the bench's draws (`default_rng(0)`: standard normal images, then masks in
[-1, 7) with -1 ignored). The JAX step is computed once, in a module-scoped
fixture (from the port's seeded weights carried over to JAX), and every case
reads it: the port's step and the bench's `rssformer_train` workload
from the same weights, and `evaluate` with TTA on the stepped weights.

At random initialisation the step is chaotic: the gradient's global norm is in
the thousands before the clip to 35, and the port against itself, with every
weight multiplied by (1 + 2e-7 n), n standard normal, moves the momentum of a
parameter tensor by up to a fifth of its largest entry, and the difference of
a whole group's momentum by 2.4% of its norm. So the gradient is held group by
group, not entry by entry. Tolerances, f32:
- losses within 2e-4 relative (`tests/test_parity_torch_e2e.py:21`'s bound;
  measured 1.5e-6);
- momentum (the clipped gradient plus the weight decay, `SGD`'s buffer after one
  step, optax's trace): 35 globally on both sides within 1e-5 (the clip is
  live); each group's norm within 1e-2 relative (measured at most 5.2e-3) and
  the norm of each group's difference within 0.1 of the group's norm (measured
  at most 3.4e-2; the port against itself as above 2.4e-2);
- the update: every parameter after the step is the one before less the
  rate times its momentum, within f32 rounding, in the port as in JAX;
- running statistics within 1e-3 of each tensor's largest entry (measured
  2.4e-4; the port against itself as above 2.1e-4);
- the aux head, which no loss reaches, equal to JAX's decayed value within f32
  rounding."""
import re
from types import SimpleNamespace

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
from representationlearning_tpu.infer.tta import HorizontalFlip as JHorizontalFlip
from representationlearning_tpu.infer.tta import Identity as JIdentity
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu.train import rssformer as JRS
from representationlearning_tpu_torch import bench as TB
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.infer.tta import HorizontalFlip, Identity
from representationlearning_tpu_torch.models.rssformer import HRNetFusion
from representationlearning_tpu_torch.ops import _build
from representationlearning_tpu_torch.train import rssformer as TRS

torch.set_num_threads(2)

LOSS_RTOL = 2e-4     # f32 end to end, the bound of tests/test_parity_torch_e2e.py:21
CLIP_RTOL = 1e-5     # the clipped global norm, 35
GROUP_NORM_RTOL = 1e-2
GROUP_DIFF = 0.1
UPDATE_RTOL = 1e-6   # p - lr m in f32, of the tensor's largest entry
STATS_TOL = 1e-3
B, SIDE, CLASSES = 2, 64, 7
LOSS_CONFIG = {"ce": {}}
CFG = TRS.RSSFormerTrainConfig()


@pytest.fixture
def no_kernels(monkeypatch):
    """On CPU tensors every wrapper runs its plain version: the loader is never asked."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    monkeypatch.setattr(_build, "load_library", refuse)


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's `create_rssformer_state` and one jitted train step on the bench's draws:
    the batch, the losses, and under the port's names the variables before and after
    and the momentum. The initial variables are the port's seeded model carried over
    by `convert_rssformer` (strict), which `create_rssformer_state` reads through
    `init`: a jit of JAX's own init compiles for longer than the step does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, SIDE, SIDE, 3)).astype(np.float32)
    mask = rng.integers(-1, CLASSES, (B, SIDE, SIDE))
    model = JHRNetFusion("hrnetv2_w18", CLASSES, loss_config=LOSS_CONFIG)
    cfg = JRS.RSSFormerTrainConfig()
    seeded = HRNetFusion("hrnetv2_w18", CLASSES, loss_config=LOSS_CONFIG, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(jnp.asarray, convert_rssformer(
        state_dict_to_numpy(seeded.state_dict()), strict=True))
    state = JRS.create_rssformer_state(
        SimpleNamespace(init=lambda *a: variables, apply=model.apply), (SIDE, SIDE, 3), cfg)
    step = JRS.make_rssformer_train_step(model, cfg)
    new, met = step(state, {"image": jnp.asarray(x), "mask": jnp.asarray(mask, jnp.int32)},
                    jax.random.PRNGKey(0))
    # make_sgd(flat=True): the momentum is one vector in the params' ravel order
    flat_params, unravel = jax.flatten_util.ravel_pytree(state.params)
    trace = [t for t in jax.tree_util.tree_leaves(new.opt_state)
             if getattr(t, "shape", None) == flat_params.shape]
    assert len(trace) == 1 and int(new.step) == 1
    return SimpleNamespace(
        x=x, mask=mask, losses={k: float(v) for k, v in met.items()},
        before=rssformer_state_dict_from_jax({"params": _np_tree(state.params),
                                              "batch_stats": _np_tree(state.batch_stats)}),
        after=rssformer_state_dict_from_jax({"params": _np_tree(new.params),
                                             "batch_stats": _np_tree(new.batch_stats)}),
        momentum=rssformer_state_dict_from_jax({"params": _np_tree(unravel(trace[0]))}))


def _port_model(sd):
    m = HRNetFusion("hrnetv2_w18", CLASSES, loss_config=LOSS_CONFIG, device="cpu")
    m.load_state_dict(sd)
    return m


def _batch(js):
    return {"image": torch.from_numpy(_nchw(js.x)), "mask": torch.from_numpy(js.mask)}


def _group(name: str) -> str:
    """The parameter group: the stem, layer1, each transition and stage, neck,
    head, headaux."""
    part = name.split(".")
    if part[0] == "backbone":
        return part[2] if re.fullmatch(r"layer1|stage\d|transition\d", part[2]) else "stem"
    return part[0]


def _group_norms(tensors: dict) -> dict:
    sums = {}
    for n, t in tensors.items():
        sums[_group(n)] = sums.get(_group(n), 0.0) + t.double().square().sum().item()
    return {g: s ** 0.5 for g, s in sums.items()}


def _check_losses(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"fc_loss", "total"}
    for k, w in want.items():
        assert abs(float(got[k]) - w) <= LOSS_RTOL * abs(w), (k, float(got[k]), w)


def _check_after(model, state, js) -> None:
    """Momentum by group, the update of every parameter, and every running
    statistic after the step, against JAX's."""
    params = dict(model.named_parameters())
    mom = {n: state.tx.optimizer.state[p]["momentum_buffer"] for n, p in params.items()}
    assert set(mom) == set(js.momentum)
    norm = sum(m.double().square().sum().item() for m in mom.values()) ** 0.5
    jnorm = sum(m.double().square().sum().item() for m in js.momentum.values()) ** 0.5
    assert abs(norm - CFG.grad_clip) <= CLIP_RTOL * CFG.grad_clip
    assert abs(jnorm - CFG.grad_clip) <= CLIP_RTOL * CFG.grad_clip
    got, want = _group_norms(mom), _group_norms(js.momentum)
    diff = _group_norms({n: mom[n] - js.momentum[n] for n in mom})
    assert len(want) == 11
    for g, w in want.items():
        assert abs(got[g] - w) <= GROUP_NORM_RTOL * w, (g, got[g], w)
        assert diff[g] <= GROUP_DIFF * w, (g, diff[g], w)
    lr = CFG.base_lr   # the schedule at 0
    for n, p in params.items():
        for after, before, m in ((p.detach(), js.before[n], mom[n]),
                                 (js.after[n], js.before[n], js.momentum[n])):
            scale = max(after.abs().max().item(), 1e-30)
            assert (after - (before - lr * m)).abs().max().item() <= UPDATE_RTOL * scale, n
    buffers = dict(model.named_buffers())
    for n, want in js.after.items():
        if n.endswith("num_batches_tracked"):
            assert int(buffers[n]) == 1, n
        elif n not in params:   # running mean and variance
            err = (buffers[n] - want).abs().max().item()
            assert err <= STATS_TOL * want.abs().max().item(), (n, err)
            assert not torch.equal(buffers[n], js.before[n]), n


def test_port_step_matches_jax(jax_step, no_kernels):
    """The port's step from JAX's initial weights: the losses, the clipped
    gradient by group, every parameter's update and every running statistic as
    JAX has them after its step."""
    js = jax_step
    model = _port_model(js.before)
    state = TRS.create_rssformer_state(model, CFG)
    state, met = TRS.make_rssformer_train_step(model, CFG, device="cpu")(state, _batch(js))
    assert state.step == 1 and state.learning_rates[0] == pytest.approx(
        CFG.base_lr * (1 - 1 / CFG.max_iters) ** CFG.power, rel=1e-12)
    _check_losses(met, js.losses)
    _check_after(model, state, js)


def test_aux_head_moves_by_weight_decay_alone(jax_step, no_kernels):
    """No loss reaches `headaux` (the gathered focal factor carries no gradient),
    yet optax decays it: p (1 - lr wd) after one step from zero momentum, in JAX
    and in the port, which gives it a zero gradient for that."""
    js = jax_step
    model = _port_model(js.before)
    state = TRS.create_rssformer_state(model, CFG)
    TRS.make_rssformer_train_step(model, CFG, device="cpu")(state, _batch(js))
    for n, p in model.headaux.named_parameters():
        name = f"headaux.{n}"
        decayed = js.before[name] * (1.0 - CFG.base_lr * CFG.weight_decay)
        torch.testing.assert_close(p.detach(), js.after[name], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(p.detach(), decayed, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state.tx.optimizer.state[p]["momentum_buffer"],
                                   CFG.weight_decay * js.before[name], rtol=1e-6, atol=0)
    assert not torch.equal(model.headaux[0].weight.detach(), js.before["headaux.0.weight"])


def test_bench_workload_first_call_matches_jax(jax_step, no_kernels):
    """`bench.build_rssformer_train` at the small size: its draws are the
    fixture's, and its first call from JAX's weights gives JAX's step; the FLOP
    count runs the same step (the state moves on)."""
    js = jax_step
    w = TB.build_rssformer_train("cpu", hrnet_type="hrnetv2_w18", side=SIDE, batch=B,
                                 dtype=torch.float32)
    np.testing.assert_array_equal(w.inputs["x"], js.x)
    np.testing.assert_array_equal(w.inputs["mask"], js.mask)
    assert w.batch == B and w.count_measured is None and w.state.step == 0
    w.model.load_state_dict(js.before)
    met = w.run()
    _check_losses(met, js.losses)
    assert float(w.reduce(met)) == float(met["total"]) and w.state.step == 1
    _check_after(w.model, w.state, js)
    assert TB.count_flops(w.count) > 0 and w.state.step == 2


def test_evaluate_with_tta_matches_jax(jax_step, no_kernels):
    """`evaluate` with [Identity, HorizontalFlip] on JAX's stepped weights (eval
    mode: the moved running statistics), two batches of one, gives JAX's
    scores, float64 from the same integer confusion matrix."""
    js = jax_step
    port = _port_model(js.after)
    variables = convert_rssformer(state_dict_to_numpy(js.after), strict=True)
    batches = [(js.x[:1], js.mask[:1]), (js.x[1:], js.mask[1:])]
    want = JRS.evaluate(JHRNetFusion("hrnetv2_w18", CLASSES, loss_config=LOSS_CONFIG),
                        variables, batches, CLASSES,
                        tta_transforms=[JIdentity(), JHorizontalFlip()])
    got = TRS.evaluate(port, [(torch.from_numpy(_nchw(x)), torch.from_numpy(m))
                              for x, m in batches], CLASSES,
                       tta_transforms=[Identity(), HorizontalFlip()], device="cpu")
    assert set(got) == set(want) == {"pAcc", "mAcc", "miou", "iou"}
    for k in ("pAcc", "mAcc", "miou"):
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_array_equal(np.array(list(got["iou"].values())),
                                  np.array(list(want["iou"].values())))
    assert 0.0 < got["pAcc"] < 1.0 and not port.training


def test_step_and_evaluate_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = HRNetFusion("hrnetv2_w18", CLASSES, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRS.make_rssformer_train_step(model, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRS.evaluate(model, [], CLASSES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.build_rssformer_train()


def test_model_keeps_the_jax_loss_fields():
    """`loss_config` and `ignore_index` are constructor fields, as in JAX; the step
    reads them: another ignore label changes the loss."""
    m = HRNetFusion("hrnetv2_w18", CLASSES, device="cpu")
    assert m.loss_config is None and m.ignore_index == -1
    m = HRNetFusion("hrnetv2_w18", CLASSES, loss_config={"ce": {}, "diceloss": {}},
                    ignore_index=255, with_transformer=False, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    mask = torch.randint(-1, CLASSES, (2, 64, 64), generator=torch.Generator().manual_seed(2))
    mask[:, :8] = 255
    m.train()
    losses = TRS.rssformer_losses(m, {"image": x, "mask": mask})
    assert set(losses) == {"fc_loss", "dice_loss"}
    assert all(torch.isfinite(v) for v in losses.values())
