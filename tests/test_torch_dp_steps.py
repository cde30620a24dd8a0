"""The data-parallel train steps of the port on 2 gloo ranks (`parallel/launch.py`).

1. The SCD step against JAX's step on a 2-device `shard_batch` mesh of the
   conftest's virtual CPU devices, at `tests/test_torch_train_scd.py`'s
   configuration (`mit_b0`, 128², batch 2 = 1 a rank, f32, flash attention on,
   the CAMs through the fused twin, `train=False` on both sides, the correlation
   loss's coordinates shared) and with its tolerances.
2. Training mode, port against port (`parallel/dryrun.py`'s arms at the JAX
   dry run's sizes: batch 4 = 2 a rank, drop path, dropout and BatchNorm batch
   statistics live): the 2-rank SCD, RML (with the on-device augmentation) and
   RSSFormer steps against the port's 1-rank step on the global batch, whose
   own agreement with JAX the single-rank tests hold. SCD and RML: losses within
   2e-5 relative (measured 1.4e-6), every gradient within 1e-5 of the largest
   gradient entry and, where a tensor's largest entry is above 1e-3 of that,
   within 1e-4 of its own (measured 7e-7 and 7e-6: f32 summation order), every
   parameter after the AdamW update within f32 rounding where its gradient is
   above 1e-6 (elsewhere Adam's first update, the rate times the gradient's sign,
   may flip on noise), and the running statistics within 1e-5. A factor of the
   world size in any gradient fails them. RSSFormer at random weights is chaotic
   (`tests/test_torch_train_rssformer.py`): its rules, losses within 2e-4,
   each parameter group's gradient norm within 1e-2 and the group's difference
   within 0.1 of it, statistics within 1e-3 of each tensor's largest entry.
3. The dry run's sliding-window arm, sharded over the model axis of the ranks,
   against the single-device path on the same padding."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import dp_common
import representationlearning_tpu.ops.pallas.attention as JA
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.parallel import mesh as JM
from representationlearning_tpu.train import optim as JO
from representationlearning_tpu.train import scd as JS
from representationlearning_tpu_torch.convert.from_jax import (named_tree_from_jax,
                                                               tscd_state_dict_from_jax)
from representationlearning_tpu_torch.parallel import dryrun as D
from representationlearning_tpu_torch.parallel.launch import spawn_ranks
from representationlearning_tpu_torch.train import optim as TO

torch.set_num_threads(2)

KW = dict(num_classes=21, crop_size=128, cam_scales=(1.0, 1.5), varm_dilations=(1, 2, 4),
          varm_iters=4, max_present=4, corr_samples=12, cam_iters=-1, energy_weight=1e-4)
OPT = dict(learning_rate=6e-5, weight_decay=0.01, warmup_iter=0, max_iter=100)
LOSSES = ("cls", "seg", "energy", "aux", "corr", "er")
WORLD = 2


@pytest.fixture(scope="module")
def scd_vs_jax(devices8):
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
    mesh = JM.make_mesh(n_data=WORLD, n_model=1, devices=devices8[:WORLD])
    batch = JM.shard_batch(mesh, {"image": x, "cls_label": cls, "img_box": box})
    assert batch["image"].sharding == NamedSharding(mesh, P(JM.DATA_AXIS))

    def loss_fn(params):
        losses, aux = JS.scd_losses({**v, "params": params}, model.apply, batch, key, cfg,
                                    JS._attn_mask(cfg), train=False, cam_apply_fn=twin.apply)
        return JS.scd_total_loss(losses, jnp.asarray(0), cfg), (losses, aux["refined_label"])

    orig = JA.flash_attention
    JA.flash_attention = functools.partial(orig, interpret=True)
    try:
        (total, (losses, refined)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            JM.replicate(mesh, v["params"]))
    finally:
        JA.flash_attention = orig
    jtx = JO.make_poly_warmup_adamw(param_labels=JO.tscd_param_labels, **OPT)
    updates, _ = jtx.update(grads, jtx.init(v["params"]), v["params"])
    after = optax.apply_updates(v["params"], updates)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = dict(total=float(total), losses={k: float(losses[k]) for k in LOSSES},
                refined=np.asarray(refined), grads=named_tree_from_jax(to_np(grads)),
                after=named_tree_from_jax(to_np(after)))
    k1, k2 = jax.random.split(jax.random.split(key)[1])   # scd.py:74, wsss.py:95
    coords = tuple(np.array(jax.random.uniform(k, (2, 12, 12, 2)) * 2.0 - 1.0) for k in (k1, k2))
    sd = {k: np.array(t) for k, t in tscd_state_dict_from_jax(to_np(v)).items()}
    before = {n: torch.from_numpy(np.array(t)) for n, t in sd.items()}
    got = spawn_ranks(dp_common.scd_step_rank, WORLD,
                      (sd, x, cls, box.astype(np.int32), coords, KW, OPT))
    return want, got, before


def test_scd_step_on_two_ranks_matches_jax_on_two_devices(scd_vs_jax):
    want, got, before = scd_vs_jax
    for rank in got:   # every rank reports the global losses
        for k in LOSSES:
            np.testing.assert_allclose(rank["metrics"][k], want["losses"][k], rtol=2e-3, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(rank["metrics"]["total"], want["total"], rtol=1e-4)
    refined = np.concatenate([r["refined"] for r in got])
    assert (refined != want["refined"]).mean() <= 2e-3
    g0 = got[0]["grads"]
    assert set(g0) == set(want["grads"])
    for n, g in g0.items():
        w = want["grads"][n].numpy()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-3, atol=5e-3 * scale, err_msg=n)
        assert torch.equal(g, got[1]["grads"][n]), n   # summed: the same on every rank
    labels = TO.tscd_param_labels(got[0]["after"])
    lr = {"backbone": OPT["learning_rate"], "head10": 10 * OPT["learning_rate"]}
    for n, p in got[0]["after"].items():
        w, g = want["after"][n].numpy(), want["grads"][n].numpy()
        assert torch.equal(p, got[1]["after"][n]), n
        if labels[n] == "norm":
            assert torch.equal(p, before[n]), n
            continue
        solid = np.abs(g) > 1e-6
        np.testing.assert_allclose(p.numpy()[solid], w[solid], rtol=0, atol=0.02 * lr[labels[n]],
                                   err_msg=n)
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=2.0 * lr[labels[n]], err_msg=n)


@pytest.fixture(scope="module")
def train_mode():
    """The dry run's three steps on 2 ranks, and on 1 rank at the same global batch."""
    two = spawn_ranks(D.run_arms, WORLD, ("cpu", torch.float32, True))
    one = D.run_arms(0, 1, "cpu", torch.float32, True, ("scd", "rml", "rssformer"),
                     batch_world=WORLD)
    return one, two


def _rss_group(name: str) -> str:
    part = name.split(".")
    if part[0] == "backbone":
        return part[2] if re.fullmatch(r"layer1|stage\d|transition\d", part[2]) else "stem"
    return part[0]


def _group_norms(tensors: dict) -> dict:
    sums = {}
    for n, t in tensors.items():
        sums[_rss_group(n)] = sums.get(_rss_group(n), 0.0) + t.double().square().sum().item()
    return {g: s ** 0.5 for g, s in sums.items()}


@pytest.mark.parametrize("arm", ["scd", "rml", "rssformer"])
def test_two_ranks_in_training_equal_one_rank_on_the_global_batch(train_mode, arm):
    one, two = train_mode
    want = one[arm]
    loss_rtol = 2e-4 if arm == "rssformer" else 2e-5
    for r in two:
        got = r[arm]
        assert got["step"] == 1 and set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            assert abs(got["metrics"][k] - w) <= loss_rtol * abs(w), (k, got["metrics"][k], w)
        for n, t in got["state"].items():   # the ranks hold the same state
            assert torch.equal(t, two[0][arm]["state"][n]), n
    got = two[0][arm]
    assert set(got["grads"]) == set(want["grads"])
    stats = [n for n in want["state"] if n.endswith(("running_mean", "running_var"))]
    assert stats
    if arm == "rssformer":
        gn, wn = _group_norms(got["grads"]), _group_norms(want["grads"])
        diff = _group_norms({n: got["grads"][n] - g for n, g in want["grads"].items()})
        for grp, w in wn.items():
            assert abs(gn[grp] - w) <= 1e-2 * w, (grp, gn[grp], w)
            assert diff[grp] <= 0.1 * w, (grp, diff[grp], w)
        for n in stats:
            w = want["state"][n]
            assert (got["state"][n] - w).abs().max() <= 1e-3 * w.abs().max(), n
        return
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for n, w in want["grads"].items():
        d = float((got["grads"][n] - w).abs().max())
        assert d <= 1e-5 * top, (n, d, top)
        if w.abs().max() > 1e-3 * top:
            assert d <= 1e-4 * float(w.abs().max()), (n, d, float(w.abs().max()))
    for n, w in want["state"].items():
        g = want["grads"].get(n)
        if not w.is_floating_point():
            assert torch.equal(got["state"][n], w), n
        elif g is None:   # running statistics
            np.testing.assert_allclose(got["state"][n], w, rtol=1e-5, atol=1e-6, err_msg=n)
        else:
            solid = g.abs() > 1e-6
            err = (got["state"][n] - w).abs()
            assert float(torch.where(solid, err, 0.0).max()) <= 1e-6 * max(1.0, float(w.abs().max())), n
            assert float(err.max()) <= 2 * 6e-4, n


def test_dry_run_sliding_arm(train_mode):
    _, two = train_mode
    for r in two:
        rec = r["sliding"]
        assert rec["shape"] == (D.CLASSES, WORLD * D.ROWS_PER_RANK, D.SIDE) and rec["finite"]
        # the model's own result depends on the batch of windows it runs in
        assert rec["max_abs_err"] <= 1e-5 * max(1.0, rec["max_abs"]), rec
