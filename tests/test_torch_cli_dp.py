"""The SCD command line (`cli/train_scd.py`) on 2 gloo ranks (`parallel/launch.py`)
against 1 rank, on `tests/test_torch_cli_wsss.py`'s tiny synthetic recipe
(`mit_b0`, 64² crops, 8 synthetic images, 6 classes, all six losses from the
first step): 2 ranks x `train.samples_per_gpu=1` against 1 rank x 2, two steps
and a validation. The logged losses agree within 2e-5 relative (f32 summation
order, as `tests/test_torch_dp_steps.py`), the validation's three mIoUs within
1e-6 (the histograms are summed exactly; the weights differ by f32 rounding), the
final weights as that file's rules hold them (where the gradient is solid, f32
rounding; elsewhere AdamW's sign-sized first steps), and rank 0 alone writes the
log, the events, the checkpoint and the images, once. The RSSFormer command line
refuses a global batch that does not divide over the ranks."""
import numpy as np
import pytest
import torch

import dp_common
from representationlearning_tpu_torch.cli import train_scd as TSCD_CLI
from representationlearning_tpu_torch.parallel.launch import spawn_ranks
from representationlearning_tpu_torch.utils import events as TE

torch.set_num_threads(2)
TINY = ["--config", "configs/scd_voc.yaml", "backbone.config=mit_b0", "dataset.crop_size=64",
        "dataset.synthetic_n=8", "train.cam_iters=-1", "train.log_iters=1",
        "dataset.num_classes=6", "train.max_iters=2", "train.eval_iters=2"]


def _scalars(work_dir) -> dict:
    lines = (work_dir / "events" / "scalars.csv").read_text().splitlines()
    assert lines[0] == "step,tag,value"
    rows = [line.split(",") for line in lines[1:]]
    keys = [(int(s), t) for s, t, _ in rows]
    assert len(keys) == len(set(keys)), "a scalar written twice"
    return {(int(s), t): float(v) for s, t, v in rows}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one_dir, two_dir = tmp_path_factory.mktemp("one"), tmp_path_factory.mktemp("two")
    orig = TE._try_tb_writer
    TE._try_tb_writer = lambda logdir: None
    try:
        one = TSCD_CLI.main(TINY + ["train.samples_per_gpu=2", f"work_dir.dir={one_dir}"],
                            device="cpu")
    finally:
        TE._try_tb_writer = orig
    rss = ["train", "data.batch_size=3", "data.crop_size=64", "data.synthetic_n=4",
           "model.hrnet_type=hrnetv2_w18", "train.num_iters=1",
           f"work_dir={two_dir / 'rss'}"]
    two = spawn_ranks(dp_common.cli_rank, 2,
                      (TINY + ["train.samples_per_gpu=1", f"work_dir.dir={two_dir}"], rss))
    return one, one_dir, two, two_dir


def test_two_ranks_log_what_one_rank_logs(runs):
    _, one_dir, two, two_dir = runs
    want, got = _scalars(one_dir), _scalars(two_dir)
    assert set(got) == set(want)
    for key, w in want.items():
        tol = 1e-6 if key[1].startswith("val/") else 2e-5 * abs(w)
        assert abs(got[key] - w) <= tol, (key, got[key], w)
    assert all(r["step"] == 2 for r in two)


def test_two_ranks_end_at_the_weights_of_one_rank(runs):
    one, _, two, two_dir = runs
    saved = torch.load(two_dir / "checkpoints" / "step_2" / "state.pt", weights_only=True)
    assert saved["step"] == 2
    for n, w in one.model.state_dict().items():
        got = two[0]["model"][n]
        assert torch.equal(got, two[1]["model"][n]) and torch.equal(got, saved["model"][n]), n
        if not w.is_floating_point():
            assert torch.equal(got, w), n
        else:
            err = float((got - w).abs().max())
            # two AdamW steps: within f32 rounding where the gradients are solid; a
            # gradient of noise size may flip the sign of an update (head10 rate 6e-4)
            assert err <= 4 * 6e-4, (n, err)
    errs = sorted(float((two[0]["model"][n] - w).abs().max())
                  for n, w in one.model.state_dict().items() if w.is_floating_point())
    assert errs[len(errs) // 2] <= 1e-6   # most tensors agree to f32 rounding


def test_rank_zero_alone_writes(runs):
    _, one_dir, _, two_dir = runs
    log = (two_dir / "train.log").read_text()
    assert log.count("iter 1/2") == 1 and log.count("iter 2/2") == 1
    assert log.count("validate @2") == 1 and log.count("config:") == 1
    assert sorted(p.name for p in (two_dir / "checkpoints").iterdir()) == ["step_2"]
    names = sorted(p.name for p in (two_dir / "events" / "images").iterdir())
    assert names == sorted(p.name for p in (one_dir / "events" / "images").iterdir())
    assert names == ["val_cam_overlay_0000002.png", "val_seg_pred_0000002.png"]


def test_rssformer_refuses_a_batch_that_does_not_divide(runs):
    _, _, two, _ = runs
    for r in two:
        assert r["refused"] is not None and "does not divide over 2 ranks" in r["refused"]
