"""DRFL's train step of the PyTorch port (`train/drfl.py`) against the JAX
package's `make_drfl_train_step`, in f32: `Softnet(3, 1)` at 64², batch 2 of the
synthetic dataset, JAX's variables drawn as in `tests/test_torch_dcl.py`.

JAX's step runs with an optax transformation that keeps the gradients in its
state and updates nothing (`capture_grads`), so the step itself hands them back.
The two libraries' dropout draws cannot agree, so the port is handed JAX's
masks: JAX's training forward runs once more with the same key and
`capture_intermediates` on its `Dropout` modules, `mask = out != 0` (a zero
input is ambiguous but contributes 0 either way), and a stand-in for
`models.dcl.dropout` feeds them to the port in its order of calls (the shared
decoder's and transformer's two passes in turn).

At random weights the f32 step is ill-conditioned: f32 rounding alone moves
single gradient entries by up to 15% of their tensor's largest (JAX against the
port; both within 2e-7 of each other in f64, `tests/test_torch_train_drfl_f64.py`),
through the 2 x 2 GroupNorms at the bottom of both UNets. So the gradients are
held by top-level module (norms within 1e-2, measured 1.7e-3; the difference
within 5e-2 of the norm, measured 1.8e-2); the three losses within 1e-4
relative; the running statistics after the decoder's two passes within 1e-5; the
update on the port's own gradient (Adam's first step is -lr * sign(g) where |g|
is far above eps)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from representationlearning_tpu.data.medical import DRFLPairedDataset, collate_drfl
from representationlearning_tpu.models import dcl as JD
from representationlearning_tpu.train import drfl as JT
from representationlearning_tpu.train.state import TrainState as JState
from representationlearning_tpu_torch.convert.from_jax import dcl_state_dict_from_jax
from representationlearning_tpu_torch.models import dcl as TD
from representationlearning_tpu_torch.train import drfl as TT
from test_torch_dcl import draw_variables

torch.set_num_threads(2)

SIDE, LAYERS = 64, 1
LOSS_REL = 1e-4
STATS = 1e-5
NORM_REL, DIFF_REL = 1e-2, 5e-2


def capture_grads():
    """An optax transformation that keeps the gradients in its state and
    updates nothing, so that JAX's own train step hands them back."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           {"grads": grads}))


def dropout_outputs(model):
    """JAX's training forward with the outputs of its `Dropout` modules
    captured; the same key draws the same masks as in the train step."""

    @jax.jit
    def run(variables, A, key):
        _, mut = model.apply(variables, A, train=True, rngs={"dropout": key},
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
        return mut["intermediates"]

    return run


def jax_reference(model, v, batch, key):
    """JAX's `make_drfl_train_step` once: losses, new running statistics,
    gradients (through `capture_grads`) and the dropout masks in the port's order."""
    jb = {k: jnp.asarray(batch[k]) for k in "ABC"}
    state = JState.create(model.apply, v, capture_grads())
    new_state, metrics = JT.make_drfl_train_step(model)(state, jb, key)
    masks = port_masks(dropout_outputs(model)(v, jb["A"], key), LAYERS)
    return dict(grads=new_state.opt_state["grads"], masks=masks,
                metrics={k: float(x) for k, x in metrics.items()},
                batch_stats=new_state.batch_stats, step=int(new_state.step))


def port_masks(intermediates, layers: int) -> list[torch.Tensor]:
    """JAX's dropout outputs -> keep masks in the port's order of calls: decode1,
    the transformer's blocks (MLP dropouts 0, 1), decode1 again, the
    transformer's blocks again, transformer2's blocks, softnethead.decode1."""
    def calls(scope, name="Dropout_0"):
        return intermediates[scope][name]["__call__"] if isinstance(scope, str) else \
            intermediates[scope[0]][scope[1]][name]["__call__"]

    def vit(name, i):
        return [calls((name, f"block{b}"), d)[i] for b in range(layers)
                for d in ("Dropout_0", "Dropout_1")]

    outs = ([calls("decode1")[0]] + vit("transformer", 0) + [calls("decode1")[1]]
            + vit("transformer", 1) + vit("transformer2", 0)
            + [calls(("softnethead", "decode1"))[0]])
    masks = []
    for o in outs:
        o = np.asarray(o)
        m = torch.from_numpy(np.array(o.transpose(0, 3, 1, 2) if o.ndim == 4 else o) != 0)
        masks.append(m)
    return masks


def feed(monkeypatch, masks):
    """Replace `models.dcl.dropout` by one that applies `masks` in turn."""
    it = iter(masks)

    def fed(x, rate, training, generator=None):
        if rate == 0.0 or not training:
            return x
        m = next(it)
        assert m.shape == x.shape, (m.shape, x.shape)
        return torch.where(m.to(x.device), x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(TD, "dropout", fed)
    return it


def batch_and_key():
    ds = DRFLPairedDataset(crop_size=SIDE, synthetic_n=2, synthetic_size=SIDE)
    return collate_drfl([ds[0], ds[1]]), jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def jax_step():
    model = JD.Softnet(3, LAYERS)
    v = draw_variables(model, (jnp.zeros((1, SIDE, SIDE, 3)),), 0)
    batch, key = batch_and_key()
    return dict(v=v, batch=batch, **jax_reference(model, v, batch, key))


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's `make_drfl_train_step` on JAX's weights and masks; the
    gradients recorded just before Adam's update."""
    model = TD.Softnet(3, LAYERS, SIDE, device="cpu")
    model.load_state_dict(dcl_state_dict_from_jax(jax_step["v"]), strict=True)
    state = TT.create_drfl_state(model, TT.DRFLConfig(), 1)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    grads = {}
    names = {id(p): k for k, p in model.named_parameters()}

    def record(opt, args, kwargs):
        for g in opt.param_groups:
            for p in g["params"]:
                grads[names[id(p)]] = p.grad.detach().clone()

    state.tx.optimizer.register_step_pre_hook(record)
    lr = state.learning_rates[0]
    with pytest.MonkeyPatch.context() as mp:
        left = feed(mp, jax_step["masks"])
        state, metrics = TT.make_drfl_train_step(model, device="cpu")(state, jax_step["batch"])
    assert next(left, None) is None   # every mask consumed
    return dict(model=model, state=state, metrics=metrics, grads=grads, before=before, lr=lr)


def test_schedule_matches_jax():
    """Flat for maintain_epoch epochs, then linear to 0 over decay_epoch + 1."""
    for cfg, spe in ((JT.DRFLConfig(lr=2e-4, maintain_epoch=3, decay_epoch=4), 5),
                     (JT.DRFLConfig(lr=1e-3, maintain_epoch=2, decay_epoch=1, epoch_count=2), 3),
                     (JT.DRFLConfig(), 0)):
        want = JT.linear_decay_schedule(cfg, spe)
        got = TT.linear_decay_schedule(TT.DRFLConfig(*cfg), spe)
        values = [got(s) for s in range(60)]
        np.testing.assert_allclose(values, [float(want(jnp.int32(s))) for s in range(60)],
                                   rtol=1e-6, atol=0)
        assert values[0] == cfg.lr and values[-1] < values[0]


def test_losses_match_jax(jax_step, port_step):
    want = jax_step["metrics"]
    got = {k: float(v) for k, v in port_step["metrics"].items()}
    assert got.keys() == want.keys() == {"G_L1", "G_bin", "bin", "total"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), k


def test_gradients_match_jax_by_module(jax_step, port_step):
    want = dcl_state_dict_from_jax({"params": jax_step["grads"]})
    assert want.keys() == port_step["grads"].keys()
    sums = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    for k, g in port_step["grads"].items():
        w = want[k].double()
        s = sums[k.split(".")[0]]
        s[0] += float((g.double() ** 2).sum())
        s[1] += float((w ** 2).sum())
        s[2] += float(((g.double() - w) ** 2).sum())
    assert len(sums) == 15
    for top, (g2, w2, d2) in sums.items():
        assert abs(g2 ** 0.5 - w2 ** 0.5) <= NORM_REL * w2 ** 0.5, top
        assert d2 ** 0.5 <= DIFF_REL * w2 ** 0.5, top


def test_running_statistics_match_jax(jax_step, port_step):
    """After the decoder's two passes (and the encoders' one) in training."""
    want = dcl_state_dict_from_jax({"batch_stats": jax_step["batch_stats"]})
    sd = port_step["model"].state_dict()
    moved = 0
    for k, w in want.items():
        if "running" in k:
            torch.testing.assert_close(sd[k], w, rtol=0, atol=STATS * max(1.0, float(w.abs().max())))
            moved += int(not torch.equal(w, dcl_state_dict_from_jax(
                {"batch_stats": jax_step["v"]["batch_stats"]})[k]))
    assert moved > 0


def test_update_is_adams_first_step(jax_step, port_step):
    """Adam's first step moves each entry by lr * g / (|g| + 1e-8): -lr * sign(g)
    where |g| > 1e-4, not at all where g = 0; the step count and rate move on."""
    lr, state = port_step["lr"], port_step["state"]
    assert lr == JT.DRFLConfig().lr and state.step == 1 == jax_step["step"]
    assert all(p.grad is None for p in port_step["model"].parameters())
    for k, p in port_step["model"].named_parameters():
        g, old = port_step["grads"][k], port_step["before"][k]
        delta = p.detach() - old
        big = g.abs() > 1e-4
        slack = 1e-3 * lr + 2.4e-7 * old.abs()
        assert bool(((delta + lr * torch.sign(g)).abs() <= slack)[big].all()), k
        assert bool((delta[g == 0] == 0).all()), k
        assert float(delta.abs().max()) <= lr * (1 + 1e-3) + 2.4e-7 * float(old.abs().max()), k
