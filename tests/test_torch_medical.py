"""DRFL's paired medical data of the PyTorch port (`data/medical.py`) against the
JAX package: the synthetic source, the dataset's shared crops and flips
(`no_flip` both ways) and `collate_drfl` give JAX's arrays exactly;
`PairedDirSource` over a directory of PNGs likewise; the dataset is registered
under JAX's name."""
import numpy as np
import pytest
from PIL import Image

from representationlearning_tpu.data import medical as JM
from representationlearning_tpu_torch.core.registry import DATASETS
from representationlearning_tpu_torch.data import medical as TM


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "name":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("idx", [0, 3])
def test_synthetic_source_matches_jax(idx):
    got, want = TM.SyntheticMedicalSource(4, 48).get(idx), JM.SyntheticMedicalSource(4, 48).get(idx)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("no_flip", [True, False])
@pytest.mark.parametrize("crop", [40, 64, 256])
def test_dataset_crops_and_flips_match_jax(no_flip, crop):
    """Crops smaller than, equal to and larger than the 64² source (the last
    cropped to the source's side), flips on and off, seed 5."""
    kw = dict(crop_size=crop, no_flip=no_flip, seed=5, synthetic_n=6, synthetic_size=64)
    t, j = TM.DRFLPairedDataset(**kw), JM.DRFLPairedDataset(**kw)
    assert len(t) == len(j) == 6
    for i in range(6):
        _same(t[i], j[i])
    side = min(crop, 64)
    s = t[0]
    assert s["A"].shape == (side, side, 3) and s["B"].shape == (side, side, 1)
    assert s["C"].shape == (2 * side, 2 * side, 1)
    assert s["A"].min() >= -1.0 and s["A"].max() <= 1.0


def test_collate_matches_jax():
    kw = dict(crop_size=32, no_flip=False, seed=1, synthetic_n=3, synthetic_size=48)
    t, j = TM.DRFLPairedDataset(**kw), JM.DRFLPairedDataset(**kw)
    _same(TM.collate_drfl([t[i] for i in range(3)]), JM.collate_drfl([j[i] for i in range(3)]))


def test_paired_dir_source_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for sub in ("images", "masks", "sr"):
        (tmp_path / sub).mkdir()
    for n in ("b.png", "a.png"):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            tmp_path / "images" / n)
        Image.fromarray(rng.integers(0, 256, (40, 36), dtype=np.uint8)).save(tmp_path / "masks" / n)
        Image.fromarray(rng.integers(0, 256, (80, 72), dtype=np.uint8)).save(tmp_path / "sr" / n)
    src_t, src_j = TM.PairedDirSource(str(tmp_path)), JM.PairedDirSource(str(tmp_path))
    assert len(src_t) == len(src_j) == 2
    for i in range(2):
        got, want = src_t.get(i), src_j.get(i)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    kw = dict(root=str(tmp_path), crop_size=32, no_flip=False, seed=4)
    t, j = TM.DRFLPairedDataset(**kw), JM.DRFLPairedDataset(**kw)
    assert isinstance(t.source, TM.PairedDirSource)
    for i in range(2):
        _same(t[i], j[i])


def test_registered_under_the_jax_name():
    assert DATASETS.get("drfl_paired") is TM.DRFLPairedDataset
