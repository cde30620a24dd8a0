"""DRFL's evaluation, checkpoints and epoch loop of the PyTorch port
(`infer/drfl_eval.py`, `train/drfl.py`) against the JAX package.

`validate`, `evaluate_drfl`, `threshold_sweep`, `binary_stats` and the HTML
gallery give JAX's numbers exactly on the same predictions: both sides evaluate
a stand-in model whose seg output is (A[..., 0] + 1) / 2, the same f32
arithmetic in both libraries, so that no pixel can flip at a threshold through
the forward's rounding (the forward itself is held in
`tests/test_torch_dcl.py`). `train_drfl` runs two epochs of the real
`Softnet(3, 1)` at 64² on the CPU, writes `net_latest.pt` and `net_best.pt`,
and a state restored from `net_latest.pt` into a fresh model repeats the next
step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data.medical import DRFLPairedDataset, collate_drfl
from representationlearning_tpu.infer import drfl_eval as JE
from representationlearning_tpu.train import drfl as JT
from representationlearning_tpu_torch.infer import drfl_eval as TE
from representationlearning_tpu_torch.models.dcl import Softnet
from representationlearning_tpu_torch.train import drfl as TT

torch.set_num_threads(2)


class GrayJ:
    """A JAX stand-in for ``Softnet``: every output is (A[..., :1] + 1) / 2."""

    def apply(self, variables, A, train=False):
        out = (A[..., :1] + 1.0) / 2.0
        return out, out, out, out, out


class Gray(torch.nn.Module):
    """The port's stand-in: the same arithmetic on NCHW images."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))   # the device it lives on

    def forward(self, x):
        out = (x[:, :1] + 1.0) / 2.0
        return out, out, out, None, None


def _batches(side=32, n=4, batch=2, seed=3):
    ds = DRFLPairedDataset(crop_size=side, synthetic_n=n, synthetic_size=side, seed=seed)
    return [collate_drfl([ds[j] for j in range(i, i + batch)]) for i in range(0, n, batch)]


@pytest.mark.parametrize("threshold", [100, 150])
def test_validate_and_evaluate_match_jax(threshold):
    batches = _batches()
    want_v = JT.validate(GrayJ(), {}, batches, threshold)
    assert TT.validate(Gray(), batches, threshold) == want_v
    want_e = JE.evaluate_drfl(GrayJ(), {}, iter(batches), threshold)
    got_e = TE.evaluate_drfl(Gray(), iter(batches), threshold)
    assert got_e == want_e and set(got_e) == {"dice", "iou", "acc", "sen", "pre"}
    assert 0.0 < got_e["dice"] < 1.0   # the thresholds cut through the predictions


def test_threshold_sweep_matches_jax():
    batches = _batches()
    got = TE.threshold_sweep(Gray(), iter(batches))
    want = JE.threshold_sweep(GrayJ(), {}, iter(batches))
    assert got == want and len(got["all"]) == 20


def test_binary_stats_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 256, (32, 32)).astype(np.float32)
    g = (rng.random((32, 32)) > 0.7) * 255.0
    for pred, gt, t in ((p, g, 150), (p, g, 50), (np.zeros((4, 4)), np.zeros((4, 4)), 150)):
        assert TE.binary_stats(pred, gt, t) == JE.binary_stats(pred, gt, t)


def test_html_gallery_matches_jax(tmp_path):
    rows = [("case_0", [("input", "a.png"), ("pred", "b.png")]), ("case_1", [("gt", "c.png")])]
    got = TE.write_html_gallery(str(tmp_path / "port"), rows, "drfl")
    want = JE.write_html_gallery(str(tmp_path / "jax"), rows, "drfl")
    assert open(got).read() == open(want).read()


def test_predictions_follow_the_model_and_jax_layout():
    x = _batches(n=2)[0]["A"]
    pred = TE.seg_predictions(Gray(), x)
    want = np.asarray(GrayJ().apply({}, jnp.asarray(x))[0])
    assert pred.shape == want.shape == (2, 32, 32, 1) and pred.dtype == np.float32
    np.testing.assert_array_equal(pred, want)


def test_train_drfl_two_epochs_and_resume(tmp_path):
    """Two epochs of one batch: a finite loss and Dice in [0, 1] an epoch, both
    checkpoints written; `load_checkpoint` into a fresh model restores the step,
    the weights, the running statistics and Adam's moments, and the next step
    from the restored state equals the next step from the trained one."""
    batches = _batches(side=64, n=2)
    gen = torch.Generator().manual_seed(0)
    model = Softnet(3, 1, 64, generator=gen, device="cpu")
    cfg = TT.DRFLConfig(lr=1e-4)
    state, history = TT.train_drfl(model, lambda: iter(batches), lambda: iter(batches), cfg,
                                   epochs=2, work_dir=str(tmp_path), device="cpu")
    assert [h["epoch"] for h in history] == [0, 1] and state.step == 2
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["dice"] <= 1.0 for h in history)
    assert (tmp_path / "net_latest.pt").exists() and (tmp_path / "net_best.pt").exists()

    fresh = Softnet(3, 1, 64, generator=torch.Generator().manual_seed(1), device="cpu")
    restored = TT.load_checkpoint(str(tmp_path), "latest", TT.create_drfl_state(fresh, cfg, 1))
    assert restored.step == 2
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(model.parameters(), fresh.parameters()):
        sa, sb = state.tx.optimizer.state[p], restored.tx.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    step = TT.make_drfl_train_step(model, device="cpu")
    step_fresh = TT.make_drfl_train_step(fresh, device="cpu")
    _, m1 = step(state, batches[0], torch.Generator().manual_seed(5))
    _, m2 = step_fresh(restored, batches[0], torch.Generator().manual_seed(5))
    assert float(m1["total"]) == pytest.approx(float(m2["total"]), rel=1e-6)
    for p, q in zip(model.parameters(), fresh.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)
    for f in tmp_path.glob("net_*.pt"):   # about a gigabyte each
        f.unlink()
