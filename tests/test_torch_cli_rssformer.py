"""The port's RSSFormer command line (`cli/rssformer.py`) against the JAX package's:
the config and its yaml merge; the first batches of the host chain and of the raw
canvases; `eval`'s scores within 1e-6 and `predict`'s PNGs pixel-equal (but at
near-ties, the two best probabilities within 1e-3) on the same weights, the
port's seeded `hrnetv2_w18` carried to JAX by `convert_rssformer` and back by
`convert/from_jax.py::rssformer_state_dict_from_jax`, in f32 on the synthetic
source's 128 x 128 images (the JAX CLI's weights come from its own restore, here
patched to those variables); then `train`, `eval --tta` and `predict` end to end
in a `tmp_path` as `tests/test_cli.py:43-76` runs the JAX CLI, with Pillow
hidden, with and without `data.device_augment`; a resume; the first step with the
HRFormer backbone (`model.hrnet_type=hrt_small`) against the JAX CLI's; the card
as the default device."""
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from representationlearning_tpu.cli import rssformer as JC
from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
from representationlearning_tpu.core.config import load_yaml as j_load_yaml
from representationlearning_tpu.data import loveda as JL
from representationlearning_tpu.models import hrt as JHRT
from representationlearning_tpu.train import optim as JO
from representationlearning_tpu.train.state import TrainState as JTrainState
from representationlearning_tpu_torch.cli import rssformer as TC
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.core.config import load_yaml
from representationlearning_tpu_torch.data import loveda as TL
from representationlearning_tpu_torch.models import hrt as THRT
from representationlearning_tpu_torch.models.layers import BatchNorm2d
from representationlearning_tpu_torch.models.rssformer import HRNetFusion
from representationlearning_tpu_torch.train import checkpoints as CK
from representationlearning_tpu_torch.train.rssformer import create_rssformer_state

from hrt_common import hrt_variables

torch.set_num_threads(2)

YAML = "configs/rssformer_loveda.yaml"
SMALL = ["model.hrnet_type=hrnetv2_w18", "data.crop_size=64", "data.batch_size=2",
         "data.synthetic_n=4", "train.num_iters=2", "train.log_interval_step=1",
         "train.eval_interval=2"]
NEAR_TIE = 1e-3


def _common(wd):
    return ["--config", YAML, *SMALL, f"work_dir={wd}"]


def _cfg(pkg_default, load, overrides):
    cfg = pkg_default()
    cfg.merge(load(YAML))
    return cfg.apply_overrides(overrides)


def test_default_config_and_yaml_merge_match_jax():
    assert TC.default_config().to_dict() == JC.default_config().to_dict()
    over = SMALL + ["data.device_augment=true", "model.fused_mlp=True", "seed=7"]
    assert _cfg(TC.default_config, load_yaml, over).to_dict() == \
        _cfg(JC.default_config, j_load_yaml, over).to_dict()


def _first_samples(ds_port, ds_jax, seed, batch, steps):
    """The samples of the CLIs' first steps: indices from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idxs = rng.integers(0, len(ds_jax), batch)
        yield [ds_port[int(i)] for i in idxs], [ds_jax[int(i)] for i in idxs]


def test_first_batches_match_jax():
    """The host chain (crop, OneOf flip / rot90, ShiftScaleRotate, normalise) as
    `collate_loveda` batches, and the raw canvases of the on-device chain."""
    kw = dict(training=True, crop_size=64, seed=2333, synthetic_n=16)
    for port, jax_s in _first_samples(TL.LoveDADataset(**kw), JL.LoveDADataset(**kw),
                                      2333, 8, 3):
        got, want = TL.collate_loveda(port), JL.collate_loveda(jax_s)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    kw = dict(training=True, crop_size=64, synthetic_n=16, raw=True, canvas_size=160)
    for port, jax_s in _first_samples(TL.LoveDADataset(**kw), JL.LoveDADataset(**kw),
                                      2333, 4, 2):
        for (pn, canvas, hw, mask), (jn, jcanvas, jhw, jmask) in zip(port, jax_s):
            assert pn == jn and canvas.dtype == torch.uint8 and mask.dtype == torch.int32
            np.testing.assert_array_equal(canvas.numpy(), jcanvas.transpose(2, 0, 1))
            np.testing.assert_array_equal(hw.numpy(), jhw)
            np.testing.assert_array_equal(mask.numpy(), jmask)


def _calmed(seed):
    """The CLI's seeded model with BatchNorm scales halved, so that its softmax is
    neither one-hot nor flat at random weights (0.3% of the pixels near-ties)."""
    m = HRNetFusion("hrnetv2_w18", 7, generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BatchNorm2d):
                mod.weight.mul_(0.5)
    return m


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of weights on both sides: JAX variables from the port's state_dict,
    and that state_dict back through `rssformer_state_dict_from_jax`, saved as the
    port CLI's checkpoint."""
    d = tmp_path_factory.mktemp("ckpt")
    model = _calmed(2333)
    variables = convert_rssformer(state_dict_to_numpy(model.state_dict()), strict=True)
    sd = rssformer_state_dict_from_jax(variables)
    model.load_state_dict(sd)
    cfg = _cfg(TC.default_config, load_yaml, SMALL)
    state = create_rssformer_state(model, TC._build(cfg, torch.device("cpu"))[1])
    state.step = 5
    CK.save(str(d / "checkpoints"), 5, state)
    return SimpleNamespace(variables=variables, ckpt=str(d / "checkpoints"), model=model)


def _jax_main(monkeypatch, weights, argv):
    """The JAX CLI with its restore patched to the shared variables."""
    def restore(cfg, args):
        return JC._build(cfg)[0], SimpleNamespace(variables=weights.variables)

    monkeypatch.setattr(JC, "_restore_for_eval", restore)
    return JC.main(argv)


def test_eval_matches_jax(weights, monkeypatch, tmp_path):
    argv = ["eval", *_common(tmp_path / "wd"), "--ckpt_dir", weights.ckpt]
    got = TC.main(argv, device="cpu")
    want = _jax_main(monkeypatch, weights, argv)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):   # the IoU of each class
            assert list(g) == list(w)
            g, w = list(g.values()), list(w.values())
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=0, atol=1e-6, equal_nan=True, err_msg=k)
    assert 0.0 < got["pAcc"] < 1.0


def test_predict_pngs_match_jax_but_at_near_ties(weights, monkeypatch, tmp_path):
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    common = [*_common(tmp_path / "wd"), "--ckpt_dir", weights.ckpt]
    assert TC.main(["predict", "--out_dir", str(out_t), *common], device="cpu") == str(out_t)
    _jax_main(monkeypatch, weights, ["predict", "--out_dir", str(out_j), *common])
    ds = TL.LoveDADataset(training=False, synthetic_n=4)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == \
        sorted(f"{ds[i][0]}.png" for i in range(len(ds)))
    near_total, classes = 0, set()
    for i in range(len(ds)):
        name, img, _ = ds[i]
        t, j = Image.open(out_t / f"{name}.png"), Image.open(out_j / f"{name}.png")
        assert t.mode == j.mode == "P" and t.getpalette() == j.getpalette()
        with torch.no_grad():
            probs = weights.model.eval()(TC._nchw(img))[0]
        top2 = probs.topk(2, dim=0).values
        near = (top2[0] - top2[1] <= NEAR_TIE).numpy()
        t, j = np.asarray(t), np.asarray(j)
        np.testing.assert_array_equal(t[~near], j[~near])
        np.testing.assert_array_equal(t, probs.argmax(0).numpy().astype(np.uint8))
        near_total += int(near.sum())
        classes |= set(np.unique(t).tolist())
    assert near_total < 0.01 * len(ds) * 128 * 128 and len(classes) > 1


@pytest.fixture
def no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("device_aug", [False, True])
def test_train_eval_predict_end_to_end(tmp_path, no_pillow, device_aug):
    wd = tmp_path / "wd"
    common = _common(wd) + (["data.device_augment=true", "data.canvas_size=128"]
                            if device_aug else [])
    state = TC.main(["train", *common], device="cpu")
    assert state.step == 2 and (wd / "checkpoints" / "step_2" / "state.pt").is_file()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    scores = TC.main(["eval", "--tta", *common], device="cpu")
    assert 0.0 <= scores["miou"] <= 1.0 and 0.0 <= scores["pAcc"] <= 1.0
    out = TC.main(["predict", "--out_dir", str(tmp_path / "pred"), *common], device="cpu")
    assert len(os.listdir(out)) == 4
    assert all(open(os.path.join(out, f), "rb").read(8) == b"\x89PNG\r\n\x1a\n"
               for f in os.listdir(out))


def test_resume_continues_from_the_saved_step(tmp_path, monkeypatch, capsys):
    """A rerun with more iterations restores the latest checkpoint (its parameters
    and step) and takes only the remaining steps, as the JAX CLI does."""
    wd = tmp_path / "wd"
    first = TC.main(["train", *_common(wd), "train.eval_interval=1"], device="cpu")
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    seen = []
    make = TC.make_rssformer_train_step

    def recording(model, cfg, device=None, **kw):
        step = make(model, cfg, device, **kw)

        def run(state, batch, generator=None):
            seen.append((state.step, all(torch.equal(v, saved[k])
                                         for k, v in state.model.state_dict().items())))
            return step(state, batch, generator)
        return run

    monkeypatch.setattr(TC, "make_rssformer_train_step", recording)
    capsys.readouterr()
    again = TC.main(["train", *_common(wd), "train.num_iters=3"], device="cpu")
    assert "resumed at step 2" in capsys.readouterr().out
    assert seen == [(2, True)] and again.step == 3
    assert sorted(os.listdir(wd / "checkpoints")) == ["step_1", "step_2", "step_3"]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_eval_model_is_built_f32_on_every_device(monkeypatch, device, fused):
    """`train`, `eval` and `predict` build the model at its default f32 whatever the
    device type and `model.fused_mlp`, as the JAX command line does; K5 then computes
    in f32 on the card. The constructor is recorded, not run (no card here)."""
    import inspect

    made = []
    monkeypatch.setattr(TC, "HRNetFusion", lambda **kw: made.append(kw))
    cfg = _cfg(TC.default_config, load_yaml, SMALL + [f"model.fused_mlp={fused}"])
    TC._build(cfg, torch.device(device))
    assert len(made) == 1 and made[0]["fused_mlp"] is fused and made[0]["device"].type == device
    assert made[0].get("dtype", torch.float32) == torch.float32
    assert inspect.signature(HRNetFusion).parameters["dtype"].default == torch.float32
    assert not hasattr(TC, "compute_dtype")


def test_f32_checkpoint_loads_strictly_into_the_bf16_eval_model(weights, tmp_path, monkeypatch):
    """The f32 trainer's checkpoint loads strictly into a model that computes in
    bf16 (the command lines build f32 models; a bf16 one is built here through the
    constructor): every name, shape and type matches (the compute dtype is not a
    parameter's)."""
    cfg = _cfg(TC.default_config, load_yaml, SMALL + ["model.fused_mlp=True"])
    monkeypatch.setattr(TC, "HRNetFusion",
                        lambda **kw: HRNetFusion(dtype=torch.bfloat16, **kw))
    model, state = TC._restore_for_eval(cfg, SimpleNamespace(ckpt_dir=weights.ckpt),
                                        torch.device("cpu"))
    assert model.backbone.hrnet.dtype == torch.bfloat16 and state.step == 5
    want = weights.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_refusals(tmp_path, monkeypatch):
    """`train ... model.hrnet_type=hrt_small`, which the port refused until the
    HRFormer backbone was ported, takes its first step as the JAX CLI does on the
    same weights (the port's seeded model carried over by `convert_hrt`) and the
    same batch, with drop path at 0 on both sides (the two libraries' draws cannot
    agree): the losses within 2e-4 relative; the update of each top-level module
    held as tests/test_torch_train_rssformer.py holds the HRNetV2 step's momentum
    (the step at random weights is chaotic): its norm within 1e-2 relative, the
    norm of the difference within 0.1 of it (measured 1.7e-2 in the stem, under
    1e-2 elsewhere); the running statistics within 1e-3 of max(their largest
    entry, 1e-3), since some running means are of order 1e-8. The card stays the
    default device."""
    for cfgs in (JHRT.HRT_CONFIGS, THRT.HRT_CONFIGS):
        monkeypatch.setitem(cfgs["hrt_small"], "drop_path_rate", 0.0)
    argv = ["train", "--config", YAML, *SMALL, "model.hrnet_type=hrt_small", "train.num_iters=1"]
    seen = {}
    make, jmake = TC.make_rssformer_train_step, JC.make_rssformer_train_step

    def recording(model, cfg, device=None, **kw):
        step = make(model, cfg, device, **kw)

        def run(state, batch, generator=None):
            seen["before"] = {k: v.clone() for k, v in model.state_dict().items()}
            state, metrics = step(state, batch, generator)
            seen["port"] = {k: float(v) for k, v in metrics.items()}
            return state, metrics
        return run

    def jax_state(model, input_shape, cfg, seed=0):
        tx = JO.make_sgd(cfg.base_lr, cfg.weight_decay, cfg.momentum,
                         schedule=JO.poly_schedule(cfg.base_lr, cfg.max_iters, cfg.power),
                         grad_clip_norm=cfg.grad_clip)
        return JTrainState.create(model.apply, hrt_variables(seen["before"]), tx)

    def jax_recording(model, cfg):
        step = jmake(model, cfg)

        def run(state, batch, key):
            state, metrics = step(state, batch, key)
            seen["jax"] = {k: float(v) for k, v in metrics.items()}
            return state, metrics
        return run

    monkeypatch.setattr(TC, "make_rssformer_train_step", recording)
    monkeypatch.setattr(JC, "make_rssformer_train_step", jax_recording)
    monkeypatch.setattr(JC, "create_rssformer_state", jax_state)
    got = TC.main([*argv, f"work_dir={tmp_path / 'port'}"], device="cpu").model.state_dict()
    jst = JC.main([*argv, f"work_dir={tmp_path / 'jax'}"])
    assert got["headaux.0.weight"].shape == (7, 32)      # the HRFormer's branch 0
    assert set(seen["port"]) == set(seen["jax"]) == {"fc_loss", "total"}
    for k, w in seen["jax"].items():
        assert abs(seen["port"][k] - w) <= 2e-4 * abs(w), (k, seen["port"][k], w)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = rssformer_state_dict_from_jax({"params": np_tree(jst.params),
                                          "batch_stats": np_tree(jst.batch_stats)})
    moved = {}
    for k, before in seen["before"].items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-3 * max(float(want[k].abs().max()), 1e-3), (k, err)
            continue
        top = ".".join(k.split(".")[:3]) if k.startswith("backbone.") else k.split(".")[0]
        d = moved.setdefault(top, [0.0, 0.0, 0.0])
        port_d, jax_d = (got[k] - before).double(), (want[k] - before).double()
        d[0] += float(port_d.square().sum())
        d[1] += float(jax_d.square().sum())
        d[2] += float((port_d - jax_d).square().sum())
    assert len(moved) > 10 and all(n > 0 for _, n, _ in moved.values())
    for top, sums in moved.items():
        norm, jax_norm, diff = (v ** 0.5 for v in sums)
        assert abs(norm - jax_norm) <= 1e-2 * jax_norm and diff <= 0.1 * jax_norm, \
            (top, norm, jax_norm, diff)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.main(["eval", *_common(tmp_path / "wd2")])
    assert not (tmp_path / "wd2").exists()
