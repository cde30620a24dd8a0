"""The RML train step as a whole: `rml_losses`, `rml_total_loss` and one optimiser
update of the port against the JAX trainer (`train/rml.py:48-138`), on the
smallest MiT (`mit_b0`) at 128 x 128, f32, batch 2, the CAMs through the fused
twin, PAR at dilations (1, 2, 4) with 4 iterations. Both sides run with
`train=False` (the two libraries' drop-path draws cannot agree; training-mode
behaviour is held module by module). Also the whole step on the CPU with the
on-device augmentation, without the kernel loader."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from representationlearning_tpu.models.rml import RMLModel as JRMLModel
from representationlearning_tpu.train import optim as JO
from representationlearning_tpu.train import rml as JR
from representationlearning_tpu.wsss import camutils as JCU
from representationlearning_tpu_torch.convert.from_jax import rml_state_dict_from_jax
from representationlearning_tpu_torch.data.device_transforms import DeviceAugConfig
from representationlearning_tpu_torch.models.rml import RMLModel
from representationlearning_tpu_torch.models.tscd import share_parameters
from representationlearning_tpu_torch.ops import _build
from representationlearning_tpu_torch.train import optim as TO
from representationlearning_tpu_torch.train import rml as TR
from representationlearning_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

# cam_scales without 0.5: the 0.3-scale forward at 38 px must keep one 8 x 8
# reduction window in stage 1 at every CAM scale
KW = dict(num_classes=21, crop_size=128, cam_scales=(1.0, 1.5), par_dilations=(1, 2, 4),
          par_iters=4, max_present=4, cam_iters=-1)
OPT = dict(learning_rate=6e-5, weight_decay=0.01, warmup_iter=0, max_iter=100)
LOSSES = ("cls", "apml", "mfml", "ciml")


def _batch():
    rng = np.random.default_rng(0)
    coarse = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    x = np.kron(coarse, np.ones((1, 16, 16, 1), np.float32)) \
        + 0.3 * rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    x[1, :, 100:] = 0.0  # a zero-padded crop
    cls = np.zeros((2, 20), np.float32)
    cls[0, [3, 11]] = 1
    cls[1, [0, 7, 19]] = 1
    box = np.array([[0, 128, 0, 128], [0, 128, 0, 100]])
    return x, cls, box


@pytest.fixture(scope="module")
def both():
    x, cls, box = _batch()
    model = JRMLModel(backbone="mit_b0", num_classes=21)
    twin = JRMLModel(backbone="mit_b0", num_classes=21, fused_blocks=True, collect_attns="none")
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    cfg = JR.RMLConfig(**KW)
    mask = jnp.asarray(JCU.get_mask_by_radius(8, 8, cfg.attn_radius))
    batch = {"image": jnp.asarray(x), "cls_label": jnp.asarray(cls), "img_box": jnp.asarray(box)}

    def loss_fn(params):
        losses, aux = JR.rml_losses({**v, "params": params}, model.apply, batch,
                                    jax.random.PRNGKey(5), cfg, mask, train=False,
                                    cam_apply_fn=twin.apply)
        total = losses["cls"] + cfg.w_apml * losses["apml"] + cfg.w_mfml * losses["mfml"] \
            + cfg.w_ciml * losses["ciml"]   # `train/rml.py:123-128` past the warm-up
        return total, (losses, aux["refined_label"])

    (total, (losses, refined)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    jtx = JO.make_poly_warmup_adamw(param_labels=JO.tscd_param_labels, **OPT)
    updates, _ = jtx.update(grads, jtx.init(v["params"]), v["params"])
    after = optax.apply_updates(v["params"], updates)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = dict(total=float(total), losses={k: float(losses[k]) for k in LOSSES},
                refined=np.asarray(refined),
                grads=rml_state_dict_from_jax({"params": to_np(grads)}),
                after=rml_state_dict_from_jax({"params": to_np(after)}))

    # the port on the same weights and inputs
    m = RMLModel("mit_b0", 21, device="cpu").eval()
    m.load_state_dict(rml_state_dict_from_jax(to_np(v)))
    t_twin = share_parameters(
        RMLModel("mit_b0", 21, fused_blocks=True, collect_attns="none", device="cpu"), m).eval()
    t_batch = {"image": torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
               "cls_label": torch.from_numpy(cls), "img_box": torch.from_numpy(box)}
    t_cfg = TR.RMLConfig(**KW)
    t_losses, t_aux = TR.rml_losses(m, t_batch, t_cfg, cam_model=t_twin)
    t_total = TR.rml_total_loss(t_losses, 0, t_cfg)
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
    assert differ <= 2e-3   # the bound of tests/test_torch_train_scd.py
    assert set(np.unique(got["refined"])) <= {0, 1, 4, 8, 12, 20, 255}
    assert (got["refined"] != 255).any() and (got["refined"] > 0).any()
    assert got["aux"]["segs"].shape == (2, 15, 128, 128)
    assert got["aux"]["cams"].shape == (2, 20, 128, 128)


@pytest.mark.parametrize("name", LOSSES)
def test_each_loss_matches_jax(both, name):
    want, got = both
    print(name, got["losses"][name], want["losses"][name])
    # f32 end to end; a label that differs at a near-tie moves the label-driven
    # losses by its share of the pixels
    np.testing.assert_allclose(got["losses"][name], want["losses"][name], rtol=2e-3, atol=1e-6)
    assert np.isfinite(got["losses"][name]) and abs(got["losses"][name]) > 1e-6


def test_total_and_warm_up_switch(both):
    want, got = both
    np.testing.assert_allclose(got["total"], want["total"], rtol=1e-4)
    losses = {k: torch.tensor(float(i + 1)) for i, k in enumerate(LOSSES)}
    cfg = TR.RMLConfig(cam_iters=2000)
    assert float(TR.rml_total_loss(losses, 2000, cfg)) == 1.0          # cls only
    assert float(TR.rml_total_loss(losses, 2001, cfg)) == pytest.approx(1.0 + 0.1 * (2 + 3 + 4))


def test_gradients_of_the_total_match_jax(both):
    want, got = both
    assert set(got["grads"]) == set(want["grads"])
    worst = 0.0
    for n, g in got["grads"].items():
        w = want["grads"][n].numpy()
        scale = max(np.abs(w).max(), 1e-6)
        worst = max(worst, np.abs(g.numpy() - w).max() / scale)
        # relative to the tensor's largest entry: f32 sums in another order through
        # two forwards of eight blocks and their backward
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=5e-3 * scale, err_msg=n)
    print(f"worst gradient error relative to its tensor's largest entry: {worst:.2e}")
    for n in ("neck.fuse_conv.0.weight", "attn_proj.weight", "classifier.weight",
              "encoder.block4.1.attn.q.weight"):
        assert got["grads"][n].abs().max() > 0, n


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
        # Adam's first update is lr * g / (|g| + eps): where |g| is far above eps = 1e-8
        # it is lr * sign(g), elsewhere it follows the gradient's small differences
        solid = np.abs(g) > 1e-6
        np.testing.assert_allclose(p.numpy()[solid], w[solid], rtol=0, atol=0.02 * lr[labels[n]],
                                   err_msg=n)
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=2.0 * lr[labels[n]], err_msg=n)


def test_train_step_defaults_to_the_card_and_runs_on_the_cpu(monkeypatch):
    """The whole step on CPU tensors, raw canvases augmented first: K1, K2 and K3
    take their plain versions and the kernel loader is never called."""
    def refuse(*a, **k):
        raise AssertionError("kernel loader called on the CPU path")

    cfg = TR.RMLConfig(**{**KW, "cam_scales": (1.0,)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TR.make_rml_train_step(None, cfg)
    monkeypatch.setattr(_build, "load_library", refuse)
    gen = torch.Generator().manual_seed(0)
    m = RMLModel("mit_b0", 21, device="cpu", generator=gen)
    twin = share_parameters(RMLModel("mit_b0", 21, fused_blocks=True, collect_attns="none",
                                     device="cpu"), m).eval()
    state = TrainState.create(m, TO.make_poly_warmup_adamw(
        m, 6e-5, 0.01, 1500, 20000, param_labels=TO.tscd_param_labels))
    step = TR.make_rml_train_step(m, cfg, cam_model=twin, device="cpu",
                                  aug_cfg=DeviceAugConfig(crop_size=128))
    rng = np.random.default_rng(1)
    batch = {"raw": torch.from_numpy(rng.integers(0, 256, (2, 3, 160, 160), dtype=np.uint8)),
             "hw": torch.tensor([[150, 160], [120, 100]], dtype=torch.int32),
             "cls_label": torch.eye(20)[:2]}
    bn = m.neck.fuse_conv[1]
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
