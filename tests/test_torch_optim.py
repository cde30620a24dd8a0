"""`train/optim.py` and `train/state.py` of the PyTorch port against the JAX
package: the schedules point by point, the parameter groups, and AdamW / SGD
updates against optax on the same parameters and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.train import optim as JO
from representationlearning_tpu_torch.convert.from_jax import (named_tree_from_jax,
                                                               tscd_state_dict_from_jax)
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.train import optim as TO
from representationlearning_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

STEPS = [0, 1, 7, 1499, 1500, 1501, 10000, 19999, 20000]


@pytest.mark.parametrize("name,jargs", [
    ("poly_warmup_schedule", (6e-5, 1500, 20000)),
    ("poly_warmup_schedule", (1e-3, 0, 20000, 1e-6, 0.9)),
    ("poly_warmup_sgd_schedule", (0.01, 1500, 20000)),
    ("poly_schedule", (0.01, 20000)),
    ("sgdr_schedule", (0.1, 5, 1, 2, 200)),
])
def test_schedules_point_by_point(name, jargs):
    js, ts = getattr(JO, name)(*jargs), getattr(TO, name)(*jargs)
    steps = list(range(0, 200, 7)) if name == "sgdr_schedule" else STEPS
    for step in steps:
        # the JAX side computes in f32 (1 - (1 - t / warm) (1 - ratio) cancels there:
        # an error of an f32 epsilon of the base rate), the port in Python floats
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=2e-6, atol=2e-7 * jargs[0],
                                   err_msg=f"{name} at {step}")


def test_schedules_past_their_end_are_zero():
    """Past max_iter the rate is 0 at any power (the JAX package's warm-up
    schedules give nan there at a fractional power: they clamp after the power)."""
    assert TO.poly_warmup_schedule(1e-3, 0, 100, power=0.9)(150) == 0.0
    assert TO.poly_warmup_sgd_schedule(1e-2, 10, 100)(150) == 0.0
    assert TO.poly_schedule(1e-2, 100)(150) == 0.0
    assert float(JO.poly_schedule(1e-2, 100)(150)) == 0.0


@pytest.fixture(scope="module")
def tscd():
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=6).init)(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(np.asarray, v)
    m = TSCD("mit_b0", 6, device="cpu")
    m.load_state_dict(tscd_state_dict_from_jax(v))
    return v, m


def test_tscd_param_labels_match_jax(tscd):
    v, m = tscd
    code = {"backbone": 0.0, "norm": 1.0, "head10": 2.0}
    want = named_tree_from_jax(jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, code[lab], np.float32),
        JO.tscd_param_labels(v["params"]), v["params"]))
    got = TO.tscd_param_labels(n for n, _ in m.named_parameters())
    assert set(got) == set(want)
    assert all(bool((want[n] == code[got[n]]).all()) for n in got)
    assert got["encoder.block1.0.norm1.weight"] == "norm" == got["encoder.patch_embed1.norm.bias"]
    assert got["encoder.block1.0.attn.q.weight"] == "backbone"
    assert got["decoder.linear_fuse.bn.weight"] == "head10" == got["classifier.weight"]


def test_three_adamw_steps_match_optax(tscd):
    v, m = tscd
    kw = dict(learning_rate=6e-3, weight_decay=0.01, warmup_iter=2, max_iter=10)
    jtx = JO.make_poly_warmup_adamw(param_labels=JO.tscd_param_labels, grad_clip_norm=5.0, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    opt_state = jtx.init(params)
    state = TrainState.create(m, TO.make_poly_warmup_adamw(
        m, param_labels=TO.tscd_param_labels, grad_clip_norm=5.0, **kw))
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    rng = np.random.default_rng(0)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = jtx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = named_tree_from_jax(jax.tree_util.tree_map(np.asarray, grads))
        for n, p in m.named_parameters():
            p.grad = tg[n].clone()
        sched = TO.poly_warmup_schedule(kw["learning_rate"], 2, 10)
        assert state.learning_rates == pytest.approx([sched(i), 10 * sched(i)])
        state.apply_gradients()
        assert state.step == i + 1 and all(p.grad is None for p in m.parameters())
    want = named_tree_from_jax(jax.tree_util.tree_map(np.asarray, params))
    labels = TO.tscd_param_labels(want)
    for n, p in m.named_parameters():
        # the same f32 arithmetic; the clip's global norm sums in another order
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=2e-5, atol=2e-6,
                                   err_msg=n)
        if labels[n] == "norm":
            assert torch.equal(p, before[n]), n      # frozen: no update, no decay
            assert p not in state.tx.optimizer.state
        else:
            assert not torch.equal(p, before[n]), n
    # the moments, by name
    inner = opt_state[1].inner_states  # (clip state, multi_transform state)
    adam = {"backbone": inner["backbone"].inner_state[0],
            "head10": inner["head10"].inner_state[0]}
    for label, st in adam.items():
        mu = named_tree_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a) if hasattr(a, "shape") else a, _unmask(st.mu)))
        for n, p in m.named_parameters():
            if labels[n] == label:
                np.testing.assert_allclose(state.tx.optimizer.state[p]["exp_avg"].numpy(),
                                           mu[n].numpy(), rtol=1e-5, atol=1e-7, err_msg=n)


def _unmask(tree):
    """An optax masked tree (MaskedNode leaves where another group owns the
    parameter) -> nested dicts of the arrays that are there."""
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            sub = _unmask(val)
            if sub:
                out[k] = sub
        elif hasattr(val, "shape"):
            out[k] = val
    return out


def test_single_group_adamw_and_sgd_match_optax():
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    for j_make, t_make in (
            (lambda: JO.make_poly_warmup_adamw(1e-2, 0.1, 2, 10),
             lambda p: TO.make_poly_warmup_adamw(p, 1e-2, 0.1, 2, 10)),
            (lambda: JO.make_sgd(0.1, 1e-2, 0.9, JO.poly_schedule(0.1, 10), 1.0, flat=False),
             lambda p: TO.make_sgd(p, 0.1, 1e-2, 0.9, TO.poly_schedule(0.1, 10), 1.0))):
        jtx = j_make()
        params = {"w": jnp.asarray(w0)}
        st = jtx.init(params)
        lin = nn.Linear(3, 5, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
        state = TrainState.create(lin, t_make([("weight", lin.weight)]))
        for g in grads:
            up, st = jtx.update({"w": jnp.asarray(g)}, st, params)
            params = optax.apply_updates(params, up)
            lin.weight.grad = torch.from_numpy(g.copy())
            state.apply_gradients()
        np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm_is_optax():
    a, b = nn.Parameter(torch.zeros(3)), nn.Parameter(torch.zeros(2))
    a.grad, b.grad = torch.tensor([3.0, 0.0, 0.0]), torch.tensor([0.0, 4.0])
    TO.clip_by_global_norm([a, b], 10.0)   # norm 5 below the bound: untouched
    assert torch.equal(a.grad, torch.tensor([3.0, 0.0, 0.0]))
    TO.clip_by_global_norm([a, b], 1.0)
    np.testing.assert_allclose(a.grad.numpy(), [0.6, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), [0, 0.8], rtol=1e-6)
