"""The train step as a whole: `scd_losses`, `scd_total_loss` and one optimiser
update of the port against the JAX trainer (`train/scd.py:65-164`), on the
smallest MiT (`mit_b0`) at 128 x 128, f32, batch 2, flash attention on, the CAMs
through the fused twin. Both sides run with `train=False` (the two libraries'
dropout and drop-path draws cannot agree; training-mode behaviour is held module
by module in tests/test_torch_train_mode.py) and share the correlation loss's
coordinates."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import representationlearning_tpu.ops.pallas.attention as JA
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.train import optim as JO
from representationlearning_tpu.train import scd as JS
from representationlearning_tpu_torch.convert.from_jax import (named_tree_from_jax,
                                                               tscd_state_dict_from_jax)
from representationlearning_tpu_torch.models.tscd import TSCD, share_parameters
from representationlearning_tpu_torch.train import optim as TO
from representationlearning_tpu_torch.train import scd as TS
from representationlearning_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

KW = dict(num_classes=21, crop_size=128, cam_scales=(1.0, 1.5), varm_dilations=(1, 2, 4),
          varm_iters=4, max_present=4, corr_samples=12, cam_iters=-1, energy_weight=1e-4)
OPT = dict(learning_rate=6e-5, weight_decay=0.01, warmup_iter=0, max_iter=100)
LOSSES = ("cls", "seg", "energy", "aux", "corr", "er")


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    coarse = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = np.kron(coarse, np.ones((1, 16, 16, 1), np.float32)) \
        + 0.3 * rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    x[1, :, 100:] = 0.0  # a zero-padded crop
    cls = np.zeros((2, 20), np.float32)
    cls[0, [3, 11]] = 1
    cls[1, [0, 7, 19]] = 1
    box = np.array([[0, 128, 0, 128], [0, 128, 0, 100]])
    model = JTSCD(backbone="mit_b0", num_classes=21, use_flash=True)
    twin = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True, collect_attns="none")
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    cfg = JS.SCDConfig(**KW)
    key = jax.random.PRNGKey(5)
    batch = {"image": jnp.asarray(x), "cls_label": jnp.asarray(cls), "img_box": jnp.asarray(box)}

    def loss_fn(params):
        losses, aux = JS.scd_losses({**v, "params": params}, model.apply, batch, key, cfg,
                                    JS._attn_mask(cfg), train=False, cam_apply_fn=twin.apply)
        return JS.scd_total_loss(losses, jnp.asarray(0), cfg), (losses, aux["refined_label"])

    orig = JA.flash_attention
    JA.flash_attention = functools.partial(orig, interpret=True)
    try:
        (total, (losses, refined)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v["params"])
    finally:
        JA.flash_attention = orig
    jtx = JO.make_poly_warmup_adamw(param_labels=JO.tscd_param_labels, **OPT)
    updates, _ = jtx.update(grads, jtx.init(v["params"]), v["params"])
    after = optax.apply_updates(v["params"], updates)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = dict(total=float(total), losses={k: float(losses[k]) for k in LOSSES},
                refined=np.asarray(refined), grads=named_tree_from_jax(to_np(grads)),
                after=named_tree_from_jax(to_np(after)))

    # the port on the same weights, inputs and coordinates
    m = TSCD("mit_b0", 21, use_flash=True, device="cpu").eval()
    m.load_state_dict(tscd_state_dict_from_jax(to_np(v)))
    t_twin = share_parameters(
        TSCD("mit_b0", 21, fused_blocks=True, collect_attns="none", device="cpu"), m).eval()
    k1, k2 = jax.random.split(jax.random.split(key)[1])   # scd.py:74, wsss.py:95
    shape = (2, 12, 12, 2)
    coords = tuple(torch.from_numpy(np.array(jax.random.uniform(k, shape) * 2.0 - 1.0))
                   for k in (k1, k2))
    t_batch = {"image": torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
               "cls_label": torch.from_numpy(cls), "img_box": torch.from_numpy(box)}
    t_cfg = TS.SCDConfig(**KW)
    t_losses, t_aux = TS.scd_losses(m, t_batch, t_cfg, TS._attn_mask(t_cfg, "cpu"),
                                    cam_model=t_twin, coords=coords)
    t_total = TS.scd_total_loss(t_losses, 0, t_cfg)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    t_total.backward()
    got = dict(total=float(t_total.detach()), losses={k: float(t_losses[k].detach())
                                                      for k in LOSSES},
               refined=t_aux["refined_label"].numpy(), aux=t_aux,
               grads={n: p.grad.clone() for n, p in m.named_parameters()})
    state = TrainState.create(m, TO.make_poly_warmup_adamw(
        m, param_labels=TO.tscd_param_labels, **OPT))
    state.apply_gradients()
    got.update(after={n: p.detach() for n, p in m.named_parameters()}, before=before,
               state=state)
    return want, got


def test_labels_agree(both):
    want, got = both
    differ = (want["refined"] != got["refined"]).mean()
    print(f"refined labels: {100 * differ:.3f}% of the pixels differ")
    assert differ <= 2e-3   # the bound of tests/test_torch_scd_infer.py's argmax maps
    assert set(np.unique(got["refined"])) <= {0, 1, 4, 8, 12, 20, 255}
    assert got["aux"]["segs"].shape == (2, 21, 128, 128)
    assert got["aux"]["cams"].shape == (2, 20, 128, 128)
    assert got["aux"]["pseudo_label"].shape == (2, 128, 128)


@pytest.mark.parametrize("name", LOSSES)
def test_each_loss_matches_jax(both, name):
    want, got = both
    print(name, got["losses"][name], want["losses"][name])
    # f32 end to end (CAMs agree to 2e-4); a label that differs at a near-tie moves
    # the label-driven losses by its share of the pixels
    np.testing.assert_allclose(got["losses"][name], want["losses"][name], rtol=2e-3, atol=1e-6)
    assert np.isfinite(got["losses"][name])
    if name in ("seg", "energy", "aux", "corr", "cls"):
        assert abs(got["losses"][name]) > 1e-6  # the comparison is not of zeros


def test_total_and_warm_up_switch(both):
    want, got = both
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-4)
    losses = {k: torch.tensor(float(i + 1)) for i, k in enumerate(LOSSES)}
    cfg = TS.SCDConfig(cam_iters=2000)
    assert float(TS.scd_total_loss(losses, 2000, cfg)) == 1.0          # cls only
    full = 1.0 + 0.1 * 2 + 0.01 * 3 + 0.1 * 4 + 0.1 * 5 + 0.1 * 6
    assert float(TS.scd_total_loss(losses, 2001, cfg)) == pytest.approx(full)
    for step in (0, 2000, 2001):
        j = JS.scd_total_loss({k: jnp.asarray(float(v)) for k, v in losses.items()},
                              jnp.asarray(step), JS.SCDConfig(cam_iters=2000))
        assert float(TS.scd_total_loss(losses, step, cfg)) == pytest.approx(float(j))


def test_gradients_of_the_total_match_jax(both):
    want, got = both
    assert set(got["grads"]) == set(want["grads"])
    worst = 0.0
    for n, g in got["grads"].items():
        w = want["grads"][n].numpy()
        scale = max(np.abs(w).max(), 1e-6)
        worst = max(worst, np.abs(g.numpy() - w).max() / scale)
        # relative to the tensor's largest entry: f32 sums in another order through
        # eight blocks and their backward
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=5e-3 * scale, err_msg=n)
    print(f"worst gradient error relative to its tensor's largest entry: {worst:.2e}")
    assert any(g.abs().max() > 0 for n, g in got["grads"].items() if "norm" in n)


def test_parameters_after_one_update_match_jax(both):
    want, got = both
    labels = TO.tscd_param_labels(got["after"])
    lr = {"backbone": OPT["learning_rate"], "head10": 10 * OPT["learning_rate"]}
    assert got["state"].step == 1
    for n, p in got["after"].items():
        w, g = want["after"][n].numpy(), want["grads"][n].numpy()
        if labels[n] == "norm":
            assert torch.equal(p, got["before"][n]), n
            np.testing.assert_array_equal(p.numpy(), w, err_msg=n)
            continue
        assert not torch.equal(p, got["before"][n]), n
        # Adam's first update is lr * g / (|g| + eps): where |g| is far above eps = 1e-8
        # it is lr * sign(g), elsewhere it follows the gradient's small differences
        solid = np.abs(g) > 1e-6
        np.testing.assert_allclose(p.numpy()[solid], w[solid], rtol=0, atol=0.02 * lr[labels[n]],
                                   err_msg=n)
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=2.0 * lr[labels[n]], err_msg=n)


def test_train_step_defaults_to_the_card_and_runs_on_the_cpu():
    cfg = TS.SCDConfig(**{**KW, "cam_scales": (1.0,)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.make_scd_train_step(None, cfg)
    m = TSCD("mit_b0", 21, use_flash=True, device="cpu",
             generator=torch.Generator().manual_seed(0))
    state = TrainState.create(m, TO.make_poly_warmup_adamw(
        m, 6e-5, 0.01, 1500, 20000, param_labels=TO.tscd_param_labels))
    step = TS.make_scd_train_step(m, cfg, device="cpu")   # no twin: the model itself, in eval
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 128, 128)).astype(np.float32)),
             "cls_label": torch.eye(20)[:2], "img_box": torch.tensor([[0, 128, 0, 128]] * 2)}
    bn = m.decoder.linear_fuse.bn
    metrics = []
    for i in range(2):
        state, met = step(state, batch, torch.Generator().manual_seed(i))
        assert set(met) == set(LOSSES) | {"total"}
        assert all(np.isfinite(float(v)) for v in met.values()) and m.training
        metrics.append({k: float(v) for k, v in met.items()})
    sched = TO.poly_warmup_schedule(6e-5, 1500, 20000)
    assert state.step == 2 and state.learning_rates == pytest.approx([sched(2), 10 * sched(2)])
    assert int(bn.num_batches_tracked) == 2   # one move per step: the main forward's only
    assert metrics[0] != metrics[1]
