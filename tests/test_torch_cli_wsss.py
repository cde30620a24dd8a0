"""The SCD and RML command lines of the PyTorch port (`cli/train_scd.py`,
`cli/train_rml.py`), the slice as a whole on the CPU (`device="cpu"`): their
configs, datasets and first batches against the JAX CLIs' (equal bits), `validate`
against JAX's on the same weights (mIoUs within 1e-6), and
`tests/test_cli.py`'s tiny synthetic recipes end to end into `tmp_path`, with a
resume and a run without Pillow.

TensorBoard's mirror is off in the recipes (`_try_tb_writer` answers None): its
import loads TensorFlow here, about ten seconds; `tests/test_torch_events.py`
holds the mirror."""
import sys

import jax
import numpy as np
import pytest
import torch

from representationlearning_tpu.cli import train_rml as JRML
from representationlearning_tpu.cli import train_scd as JSCD
from representationlearning_tpu.data.voc import BatchLoader as JBatchLoader
from representationlearning_tpu.data.voc import VOC12SegDataset as JSeg
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.train import scd as JS
from representationlearning_tpu_torch.cli import train_rml as TRML
from representationlearning_tpu_torch.cli import train_scd as TSCD_CLI
from representationlearning_tpu_torch.convert.from_jax import tscd_state_dict_from_jax
from representationlearning_tpu_torch.data.voc import BatchLoader as TBatchLoader
from representationlearning_tpu_torch.data.voc import VOC12SegDataset as TSeg
from representationlearning_tpu_torch.train import scd as TS
from representationlearning_tpu_torch.utils import events as TE

torch.set_num_threads(2)

MIOU_TOL = 1e-6
TINY = ["backbone.config=mit_b0", "dataset.crop_size=64", "dataset.synthetic_n=8",
        "train.cam_iters=-1", "train.log_iters=1", "train.samples_per_gpu=1"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(TE, "_try_tb_writer", lambda logdir: None)


def test_default_configs_match_jax():
    assert TSCD_CLI.default_config().to_dict() == JSCD.default_config().to_dict()
    assert TRML.default_config().to_dict() == JRML.default_config().to_dict()


@pytest.mark.parametrize("yaml", ["scd_voc", "scd_coco", "rml_voc", "rml_coco"])
def test_yaml_configs_parse_as_jax_merges_them(yaml):
    argv = ["--config", f"configs/{yaml}.yaml", "train.max_iters=5"]
    j_default = (JSCD if yaml.startswith("scd") else JRML).default_config()
    t_default = (TSCD_CLI if yaml.startswith("scd") else TRML).default_config()
    want = j_default.merge(JSCD.load_yaml(argv[1])).apply_overrides(argv[2:])
    got = TSCD_CLI.parse_config(argv[2:] + argv[:2], t_default)   # overrides first
    assert got.to_dict() == want.to_dict()


def test_check_max_present_refuses_coco_with_a_cap(tmp_path):
    coco = TSCD_CLI.parse_config(["--config", "configs/scd_coco.yaml"])
    assert TSCD_CLI.check_max_present(coco) is None
    voc = TSCD_CLI.parse_config(["--config", "configs/scd_voc.yaml"])
    assert TSCD_CLI.check_max_present(voc) == 8 == JSCD.check_max_present(voc)
    coco.dataset.max_present = 8
    with pytest.raises(ValueError, match="max_present"):
        TSCD_CLI.check_max_present(coco)
    for main, yaml, wd in ((TSCD_CLI.main, "scd_coco", f"work_dir.dir={tmp_path / 's'}"),
                           (TRML.main, "rml_coco", f"work_dir={tmp_path / 'r'}")):
        with pytest.raises(ValueError, match="max_present"):
            main(["--config", f"configs/{yaml}.yaml", "dataset.max_present=8",
                  "train.max_iters=1", wd] + TINY, device="cpu")


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device_aug", [False, True])
@pytest.mark.parametrize("yaml", ["scd_voc", "scd_coco"])
def test_first_batches_match_jax(yaml, device_aug):
    argv = ["--config", f"configs/{yaml}.yaml", "dataset.crop_size=64", "dataset.synthetic_n=8",
            "dataset.canvas_size=128"]
    cfg = TSCD_CLI.parse_config(argv)
    t_train, t_val = TSCD_CLI.make_wsss_datasets(cfg, device_aug)
    j_train, j_val = JSCD.make_wsss_datasets(cfg, device_aug)
    assert type(t_train).__name__ == type(j_train).__name__
    assert type(t_val).__name__ == type(j_val).__name__
    t_it = iter(TBatchLoader(t_train, 2, seed=cfg.seed))
    j_it = iter(JBatchLoader(j_train, 2, seed=cfg.seed))
    for _ in range(2):
        got, want = next(t_it), next(j_it)
        _same(got, want)
        step = TSCD_CLI.to_step_batch(got, device_aug)
        if device_aug:
            assert step["raw"].shape == (2, 3, 128, 128) and step["raw"].dtype == torch.uint8
            np.testing.assert_array_equal(step["raw"].permute(0, 2, 3, 1).numpy(), want[1])
        else:
            assert step["image"].shape == (2, 3, 64, 64)
            np.testing.assert_array_equal(step["image"].permute(0, 2, 3, 1).numpy(), want[1])
            assert step["img_box"].dtype == torch.int32
    for i in range(3):
        _same(t_val[i], j_val[i])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_twins_are_built_f32_on_every_device(monkeypatch, device):
    """The fused twins of both command lines compute in f32 whatever the device type,
    as the JAX command lines build them (`fused_blocks=True` at the model's default
    dtype): the validation and CAM twins of `cli.train_scd`, the CAM twin of
    `cli.train_rml`. The constructors are recorded, not run (no card here)."""
    import inspect

    from representationlearning_tpu_torch.models.rml import RMLModel
    from representationlearning_tpu_torch.models.tscd import TSCD

    made = []

    class Recorded(torch.nn.Module):
        def __init__(self, *a, **kw):
            super().__init__()
            made.append(kw)

    for mod, name in ((TSCD_CLI, "TSCD"), (TRML, "RMLModel")):
        monkeypatch.setattr(mod, name, Recorded)
        monkeypatch.setattr(mod, "share_parameters", lambda twin, model: twin)
    TSCD_CLI.build_models(TSCD_CLI.parse_config(["backbone.config=mit_b0"]), torch.device(device))
    TRML.build_models(TRML.parse_config(["backbone.config=mit_b0"], TRML.default_config()),
                      torch.device(device))
    twins = [kw for kw in made if kw.get("fused_blocks")]
    assert len(made) == 5 and len(twins) == 3
    assert all(kw.get("dtype", torch.float32) == torch.float32 and kw["device"].type == device
               for kw in twins)
    for cls in (TSCD, RMLModel):
        assert inspect.signature(cls).parameters["dtype"].default == torch.float32
    assert not hasattr(TSCD_CLI, "twin_dtype")


def test_validate_matches_jax():
    """The port's `validate` through its validation twin (the trained model's
    parameters loaded from JAX's variables, shared by the twin) against JAX's
    `validate` on those variables: mit_b0, 6 classes, four 64 x 64 images."""
    cfg = TSCD_CLI.parse_config(["--config", "configs/scd_voc.yaml", "backbone.config=mit_b0",
                                 "dataset.num_classes=6", "dataset.crop_size=64"])
    kw = dict(num_classes=6, crop_size=64, cam_scales=tuple(cfg.cam.scales), max_present=8)
    data = dict(split="val", num_classes=6, synthetic_n=4, synthetic_size=(64, 64))
    j_model = JTSCD(backbone="mit_b0", num_classes=6, fused_blocks=True)
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=6).init)(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)))
    j_cfg = JS.SCDConfig(**kw)
    want = JSCD.validate(j_model, v, JSeg(**data), JS.make_scd_eval_step(j_model.apply, j_cfg),
                         j_cfg)

    model, model_eval, cam_twin = TSCD_CLI.build_models(cfg, torch.device("cpu"))
    model.load_state_dict(tscd_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)))
    assert model_eval.training is False and cam_twin.training is False
    assert model_eval.encoder.block1[0].attn.q.weight is model.encoder.block1[0].attn.q.weight
    t_cfg = TS.SCDConfig(**kw)
    got = TSCD_CLI.validate(TSeg(**data), TS.make_scd_eval_step(model_eval, t_cfg, device="cpu"),
                            t_cfg)
    for k in ("seg", "cam", "ref"):
        print(k, got[k]["miou"], want[k]["miou"])
        assert abs(got[k]["miou"] - want[k]["miou"]) <= MIOU_TOL
        assert 0.0 <= got[k]["miou"] <= 1.0


def _csv_tags(work_dir):
    lines = (work_dir / "events" / "scalars.csv").read_text().splitlines()
    assert lines[0] == "step,tag,value"
    return [(int(s), t) for s, t, _ in (line.split(",") for line in lines[1:])]


def _scd(tmp_path, yaml, classes, extra=(), iters=2):
    state = TSCD_CLI.main(["--config", f"configs/{yaml}.yaml", *TINY,
                           f"dataset.num_classes={classes}", f"train.max_iters={iters}",
                           "train.eval_iters=2", f"work_dir.dir={tmp_path}", *extra],
                          device="cpu")
    assert state.step == iters
    assert (tmp_path / "checkpoints" / "step_2" / "state.pt").is_file()
    tags = _csv_tags(tmp_path)
    for step in range(1, iters + 1):
        assert (step, "train/cls") in tags and (step, "train/total") in tags
    for k in ("seg", "cam", "ref"):
        assert (2, f"val/{k}_miou") in tags
    for name in ("val_cam_overlay", "val_seg_pred"):
        assert (tmp_path / "events" / "images" / f"{name}_0000002.png").is_file()
    return state


@pytest.mark.parametrize("recipe", ["host", "device_augment", "coco"])
def test_train_scd_recipes(tmp_path, recipe):
    """`tests/test_cli.py`'s SCD recipes: host augmentation, on-device
    augmentation from 128 canvases, and the COCO family at 9 classes."""
    if recipe == "coco":
        _scd(tmp_path, "scd_coco", 9)
    else:
        extra = ["dataset.device_augment=true", "dataset.canvas_size=128"] \
            if recipe == "device_augment" else []
        _scd(tmp_path, "scd_voc", 6, extra)
    log = (tmp_path / "train.log").read_text()
    assert "iter 2/2" in log and "validate @2" in log


def test_train_scd_resumes(tmp_path):
    """From step 2's checkpoint to step 3: the state is restored, the loop
    continues (the loader starts again at epoch 0, as in JAX)."""
    _scd(tmp_path, "scd_voc", 6)
    saved = torch.load(tmp_path / "checkpoints" / "step_2" / "state.pt", weights_only=True)
    state = _scd(tmp_path, "scd_voc", 6, iters=3)
    assert "resumed from step 2" in (tmp_path / "train.log").read_text()
    assert (tmp_path / "checkpoints" / "step_3" / "state.pt").is_file()
    resumed = torch.load(tmp_path / "checkpoints" / "step_3" / "state.pt", weights_only=True)
    assert resumed["step"] == 3 and saved["step"] == 2
    assert state.tx.scheduler.last_epoch == 3
    name = "decoder.linear_pred.weight"
    assert not torch.equal(resumed["model"][name], saved["model"][name])
    assert _csv_tags(tmp_path).count((3, "train/cls")) == 1


def test_train_scd_device_augment_without_pillow(tmp_path, monkeypatch):
    """The on-device augmentation recipe needs no Pillow: with the package
    unimportable it runs and writes its PNGs."""
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    _scd(tmp_path, "scd_voc", 6, ["dataset.device_augment=true", "dataset.canvas_size=128"])


@pytest.mark.parametrize("recipe", ["host", "device_augment", "coco"])
def test_train_rml_recipes(tmp_path, recipe):
    """`tests/test_cli.py`'s RML recipes (one step, CAM scales 1 and 0.5)."""
    yaml, classes = ("rml_coco", 9) if recipe == "coco" else ("rml_voc", 6)
    extra = ["dataset.device_augment=true", "dataset.canvas_size=128"] \
        if recipe == "device_augment" else []
    state = TRML.main(["--config", f"configs/{yaml}.yaml", *TINY,
                       f"dataset.num_classes={classes}", "train.max_iters=1",
                       "train.eval_iters=1", "cam.scales=[1.0,0.5]", f"work_dir={tmp_path}",
                       *extra], device="cpu")
    assert state.step == 1
    assert (tmp_path / "checkpoints" / "step_1" / "state.pt").is_file()
    log = (tmp_path / "train.log").read_text()
    assert "iter 1/1" in log and "apml=" in log and "ciml=" in log
