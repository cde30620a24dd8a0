"""The port's RSSFormer command line (`cli/rssformer.py`) against the JAX package's:
the config and its yaml merge; the first batches of the host chain and of the raw
canvases; `eval`'s scores within 1e-6 and `predict`'s PNGs pixel-equal (but at
near-ties, the two best probabilities within 1e-3) on the same weights, the
port's seeded `hrnetv2_w18` carried to JAX by `convert_rssformer` and back by
`convert/from_jax.py::rssformer_state_dict_from_jax`, in f32 on the synthetic
source's 128 x 128 images (the JAX CLI's weights come from its own restore, here
patched to those variables); then `train`, `eval --tta` and `predict` end to end
in a `tmp_path` as `tests/test_cli.py:43-76` runs the JAX CLI, with Pillow
hidden, with and without `data.device_augment`; a resume; the refusals."""
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from representationlearning_tpu.cli import rssformer as JC
from representationlearning_tpu.convert.torch2jax import convert_rssformer, state_dict_to_numpy
from representationlearning_tpu.core.config import load_yaml as j_load_yaml
from representationlearning_tpu.data import loveda as JL
from representationlearning_tpu_torch.cli import rssformer as TC
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.core.config import load_yaml
from representationlearning_tpu_torch.data import loveda as TL
from representationlearning_tpu_torch.models.layers import BatchNorm2d
from representationlearning_tpu_torch.models.rssformer import HRNetFusion
from representationlearning_tpu_torch.train import checkpoints as CK
from representationlearning_tpu_torch.train.rssformer import create_rssformer_state

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

    def recording(model, cfg, device=None):
        step = make(model, cfg, device)

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


def test_f32_checkpoint_loads_strictly_into_the_bf16_eval_model(weights, tmp_path, monkeypatch):
    """With `model.fused_mlp` on the card, eval and predict build the model to
    compute in bf16 and load the f32 trainer's checkpoint into it: every name,
    shape and type matches (the compute dtype is not a parameter's)."""
    cfg = _cfg(TC.default_config, load_yaml, SMALL + ["model.fused_mlp=True"])
    cuda = torch.device("cuda")
    assert TC.compute_dtype(cfg, cuda, inference=True) == torch.bfloat16
    assert TC.compute_dtype(cfg, cuda, inference=False) == torch.float32
    assert TC.compute_dtype(cfg, torch.device("cpu"), inference=True) == torch.float32
    off = _cfg(TC.default_config, load_yaml, SMALL)
    assert TC.compute_dtype(off, cuda, inference=True) == torch.float32
    monkeypatch.setattr(TC, "compute_dtype", lambda *a, **k: torch.bfloat16)
    model, state = TC._restore_for_eval(cfg, SimpleNamespace(ckpt_dir=weights.ckpt),
                                        torch.device("cpu"))
    assert model.backbone.hrnet.dtype == torch.bfloat16 and state.step == 5
    want = weights.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_refusals(tmp_path):
    """hrt_* stays refused until the HRFormer backbone is ported; the card is the
    default device."""
    with pytest.raises(NotImplementedError, match="HRFormer"):
        TC.main(["train", *_common(tmp_path / "wd"), "model.hrnet_type=hrt_small"],
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.main(["eval", *_common(tmp_path / "wd2")])
    assert not (tmp_path / "wd2").exists()
