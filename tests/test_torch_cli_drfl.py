"""DRFL's command line of the PyTorch port (`cli/train_drfl.py`), run as
`tests/test_cli.py::test_drfl_cli_train_and_sweep` runs the JAX one (a tiny
synthetic recipe from `configs/drfl.yaml`, end to end, into `tmp_path`), on the
CPU by `device="cpu"`; the default config without data, which JAX cannot run
(its model is built at 256² and the 64² synthetic source is cropped to 64²),
refused with a `ValueError` before any model is built."""
import numpy as np
import pytest
import torch

from representationlearning_tpu.cli import train_drfl as JCLI
from representationlearning_tpu_torch.cli import train_drfl as TCLI

torch.set_num_threads(2)


def test_default_config_matches_jax():
    assert TCLI.default_config().to_dict() == JCLI.default_config().to_dict()


def test_train_then_test_and_sweep(tmp_path):
    common = ["--config", "configs/drfl.yaml", "crop_size=64", "synthetic_size=64",
              "synthetic_n=2", "batch_size=2", "epochs=1", "num_vit_layers=1",
              f"output={tmp_path}"]
    history = TCLI.main(["train"] + common, device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert (tmp_path / "net_latest.pt").exists() and (tmp_path / "net_best.pt").exists()
    res = TCLI.main(["test", "--sweep"] + common, device="cpu")
    assert "best_threshold" in res and res["best_threshold"] in res["all"]
    scores = TCLI.main(["test", "--epoch", "latest"] + common, device="cpu")
    assert set(scores) == {"dice", "iou", "acc", "sen", "pre"}
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    for f in tmp_path.glob("net_*.pt"):   # about a gigabyte each
        f.unlink()


def test_default_config_without_data_is_refused(tmp_path):
    with pytest.raises(ValueError, match="64 x 64 but crop_size is 256"):
        TCLI.main(["train", "--config", "configs/drfl.yaml", f"output={tmp_path}"], device="cpu")
    assert not any(tmp_path.iterdir())
