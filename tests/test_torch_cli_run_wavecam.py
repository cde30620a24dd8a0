"""WaveCAM's command line of the PyTorch port (`cli/run_wavecam.py`) against the JAX
package's `cli/run_wavecam.py`:

- the flags and defaults: both `main`s parse the same argument lists (none, every
  flag, the gates in another order and among the flags) into equal
  `WaveCAMConfig`s and the same stages, each package's pipeline replaced by a
  recorder;
- all nine gates end to end on the CPU in a `tmp_path` with Pillow hidden, as
  tests/test_cli.py runs JAX's (the synthetic source cut to four images of 48², so
  that the eight grid-CRF passes stay within seconds);
- `main()` without `device=` raises where there is no CUDA, before it writes.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from representationlearning_tpu.cli import run_wavecam as JC
from representationlearning_tpu_torch.cli import run_wavecam as TC
from representationlearning_tpu_torch.wsss.wavecam_pipeline import WaveCAMConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

ALL_FLAGS = [
    "--work_dir", "w", "--voc12_root", "voc", "--coco_root", "coco", "--name_list_dir", "lists",
    "--n_classes", "7", "--crop_size", "320", "--cam_batch_size", "8", "--cam_epochs", "2",
    "--cam_learning_rate", "0.05", "--cam_scales", "1.0", "0.75", "--cam_eval_thres", "0.3",
    "--conf_fg_thres", "0.4", "--conf_bg_thres", "0.05", "--irn_crop_size", "256",
    "--irn_batch_size", "16", "--irn_num_epoches", "4", "--irn_learning_rate", "0.02",
    "--beta", "8", "--exp_times", "6", "--sem_seg_bg_thres", "0.3",
]


def _parsed(module, monkeypatch, argv):
    """(config as a dict, stages) that ``module.main(argv)`` hands its pipeline."""
    seen = {}

    class Recorder:
        def __init__(self, cfg, device=None):
            seen["cfg"] = dataclasses.asdict(cfg)

        def run(self, passes):
            seen["passes"] = list(passes)
            return {}

    monkeypatch.setattr(module, "WaveCAMPipeline", Recorder)
    module.main(argv)
    return seen["cfg"], seen["passes"]


@pytest.mark.parametrize("argv", [
    [],
    ALL_FLAGS + [f"--{s}_pass" for s in JC.STAGES],
    ["--eval_sem_seg_pass", "--train_cam_pass"] + ALL_FLAGS[:18] + ["--make_wavecam_pass"]
    + ALL_FLAGS[18:],
    ["--cam_scales", "0.5", "--train_irn_pass", "--crop_size", "64"],
], ids=["defaults", "every_flag", "gates_among_flags", "scales_then_gate"])
def test_flags_and_defaults_match_jax(monkeypatch, argv):
    assert TC.STAGES == JC.STAGES
    want = _parsed(JC, monkeypatch, argv)
    got = _parsed(TC, monkeypatch, argv)
    assert got == want
    assert got[1] == [s for s in TC.STAGES if f"--{s}_pass" in argv]


def test_help_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "representationlearning_tpu_torch.cli.run_wavecam",
                          "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert "--irn_num_epoches" in out and "--make_sem_seg_pass" in out


def test_all_nine_gates_end_to_end_without_pillow(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(TC, "WaveCAMConfig",
                        functools.partial(WaveCAMConfig, synthetic_n=4, synthetic_size=(48, 48)))
    work = tmp_path / "work"
    results = TC.main([
        "--work_dir", str(work), "--n_classes", "5", "--crop_size", "48",
        "--cam_batch_size", "2", "--cam_epochs", "1", "--cam_learning_rate", "0.005",
        "--cam_scales", "1.0", "0.5", "--irn_crop_size", "96", "--irn_batch_size", "2",
        "--irn_num_epoches", "1", "--irn_learning_rate", "0.005", "--exp_times", "2",
    ] + [f"--{s}_pass" for s in TC.STAGES], device="cpu")
    assert list(results) == TC.STAGES
    assert 0.0 <= results["eval_cam"] <= 1.0 and 0.0 <= results["eval_sem_seg"] <= 1.0
    assert sorted(os.listdir(work / "weights")) == ["cam.npy", "irn.npy", "wavecam.npy"]
    for sub in ("cam", "ir_label", "sem_seg"):
        assert len(os.listdir(work / sub)) == 4
    lab = np.load(work / "ir_label" / "synthetic_000000.npy")
    assert lab.dtype == np.uint8 and set(np.unique(lab)) <= set(range(6)) | {255}
    irn = np.load(work / "weights" / "irn.npy", allow_pickle=True).item()
    assert np.abs(irn["mean_shift.running_mean"]).max() > 0


def test_main_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.main(["--work_dir", str(tmp_path / "w"), "--train_cam_pass"])
    assert not any(tmp_path.iterdir())
