"""The segmentation metrics (`metrics/seg.py`) of the port against the JAX
package's on integer labels: exact equality. Only the histogram's type differs:
the port counts in int64 with `torch.bincount`, JAX adds 1.0 in f32 (exact below
2^24 a bin a call). Labels outside [0, C), 255 among them, are not counted."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.metrics import seg as JS
from representationlearning_tpu_torch.metrics import seg as TS

C = 7


def _labels(seed=0, n=(3, 24, 32)):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, C, n)
    true[0][true[0] == 4] = 2                      # class 4 absent from image 0
    true[rng.random(n) < 0.1] = 255
    true[rng.random(n) < 0.05] = -1
    true[rng.random(n) < 0.03] = C                 # just outside the classes
    pred = rng.integers(0, C, n)
    pred[true == 1] = 1                            # some agreement
    return true, pred


def test_confusion_matrix_equals_jax():
    true, pred = _labels()
    want = np.asarray(JS.confusion_matrix(jnp.asarray(true), jnp.asarray(pred), C))
    got = TS.confusion_matrix(torch.from_numpy(true), torch.from_numpy(pred), C)
    assert got.dtype == torch.int64 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    valid = (true >= 0) & (true < C)
    assert int(got.sum()) == int(valid.sum()) < true.size


def test_confusion_matrix_ignores_predictions_outside_the_classes():
    """An argmax never gives one; the port leaves such a pixel out."""
    true = torch.tensor([0, 1, 2, 3])
    pred = torch.tensor([0, -1, C, 3])
    got = TS.confusion_matrix(true, pred, C)
    assert int(got.sum()) == 2 and got[0, 0] == 1 and got[3, 3] == 1


def test_confusion_matrix_counts_past_f32_exactness():
    """int64 counts stay exact where an f32 count would stop at 2^24."""
    n = 2 ** 24 + 3
    got = TS.confusion_matrix(torch.zeros(n, dtype=torch.int32),
                              torch.zeros(n, dtype=torch.int32), 2)
    assert int(got[0, 0]) == n


@pytest.mark.parametrize("fn", ["scores", "pseudo_scores"])
def test_scores_equal_jax(fn):
    true, pred = _labels(1)
    if fn == "pseudo_scores":
        pred[np.random.default_rng(2).random(pred.shape) < 0.2] = 255
    want = getattr(JS, fn)(list(true), list(pred), C)
    got = getattr(TS, fn)(list(true), list(pred), C)
    assert set(got) == set(want) == {"pAcc", "mAcc", "miou", "iou"}
    for k in ("pAcc", "mAcc", "miou"):
        assert got[k] == want[k], k
    assert got["iou"].keys() == want["iou"].keys()
    np.testing.assert_array_equal(np.array(list(got["iou"].values())),
                                  np.array(list(want["iou"].values())))


def test_scores_from_hist_takes_a_tensor_and_masks_absent_classes():
    true, pred = _labels(3)
    hist = TS.confusion_matrix(torch.from_numpy(true), torch.from_numpy(pred), C)
    want = JS.scores_from_hist(np.asarray(JS.confusion_matrix(jnp.asarray(true),
                                                              jnp.asarray(pred), C)))
    got = TS.scores_from_hist(hist)
    for k in ("pAcc", "mAcc", "miou"):
        assert got[k] == want[k], k
    hist = hist.clone()
    hist[5] = 0   # class 5 never in the ground truth: out of the mIoU
    got, want = TS.scores_from_hist(hist), JS.scores_from_hist(hist.numpy())
    assert got["miou"] == want["miou"] and np.isnan(got["iou"][5]) == np.isnan(want["iou"][5])


def test_accumulator_equals_jax_over_batches():
    j, t = JS.SegMetricAccumulator(C), TS.SegMetricAccumulator(C)
    for seed in range(3):
        true, pred = _labels(10 + seed, (2, 16, 20))
        j.update(true, pred)
        t.update(torch.from_numpy(true), torch.from_numpy(pred))
    assert t.hist.dtype == torch.int64
    np.testing.assert_array_equal(t.hist.numpy(), j.hist.astype(np.int64))
    got, want = t.compute(), j.compute()
    for k in ("pAcc", "mAcc", "miou"):
        assert got[k] == want[k], k


def test_multilabel_f1_dice_and_iou_equal_jax():
    rng = np.random.default_rng(4)
    yt, yp = rng.random((4, 20)) > 0.7, rng.random((4, 20)) > 0.6
    assert TS.multilabel_f1(yt, yp) == JS.multilabel_f1(yt, yp)
    assert TS.multilabel_f1(np.zeros(5), np.zeros(5)) == JS.multilabel_f1(np.zeros(5),
                                                                           np.zeros(5)) == 0.0
    a = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    b = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    for thr in (0, 150, 255):
        assert TS.dice_coefficient(a, b, thr) == JS.dice_coefficient(a, b, thr)
        assert TS.iou_score(a, b, thr) == JS.iou_score(a, b, thr)
