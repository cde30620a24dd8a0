"""The VOC / COCO datasets of the PyTorch port (`data/voc.py`, `data/coco.py`) against
the JAX package's: the same sources, seeds and indices give equal samples (names,
dtypes, shapes and bits; tolerance: none), with augmentation and without, the raw
canvases of the on-device chain, the batch loader over two epochs, the k-fold split,
the filesystem readers on a tiny JPEG / PNG tree, and the registry's names."""
import numpy as np
import pytest
from PIL import Image

from representationlearning_tpu.core.registry import DATASETS as J_DATASETS
from representationlearning_tpu.data import coco as JC
from representationlearning_tpu.data import voc as JV
from representationlearning_tpu_torch.core.registry import DATASETS as T_DATASETS
from representationlearning_tpu_torch.data import coco as TC
from representationlearning_tpu_torch.data import voc as TV


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, str):
        assert got == want
        return
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _same_items(t_ds, j_ds, idxs=range(4)):
    assert len(t_ds) == len(j_ds)
    for i in idxs:
        _same(t_ds[i], j_ds[i])


def test_synthetic_source_and_class_labels():
    t = TV.SyntheticSegSource(n=5, size=(40, 56), num_classes=9)
    j = JV.SyntheticSegSource(n=5, size=(40, 56), num_classes=9)
    for i in range(5):
        _same(t.get(i), j.get(i))
        mask = j.get(i)[2]
        for ignore in (255, 3):
            _same(TV.cls_onehot_from_mask(mask, 9, ignore),
                  JV.cls_onehot_from_mask(mask, 9, ignore))
    assert TV.NUM_VOC_CLASSES == JV.NUM_VOC_CLASSES
    assert TC.NUM_COCO_CLASSES == JC.NUM_COCO_CLASSES
    assert TC.COCO_CATEGORY_MAP == JC.COCO_CATEGORY_MAP


@pytest.mark.parametrize("aug", [True, False])
@pytest.mark.parametrize("family", ["voc", "coco"])
def test_cls_dataset(family, aug):
    kw = dict(crop_size=64, num_classes=21 if family == "voc" else 81, aug=aug, seed=3,
              synthetic_n=6)
    mod_t, mod_j = (TV, JV) if family == "voc" else (TC, JC)
    name = "VOC12ClsDataset" if family == "voc" else "CocoClsDataset"
    _same_items(getattr(mod_t, name)(**kw), getattr(mod_j, name)(**kw), range(6))


def test_cls_dataset_options():
    kw = dict(crop_size=48, rescale_range=(0.8, 1.2), img_fliplr=False, seed=7, synthetic_n=4,
              synthetic_size=(50, 70))
    _same_items(TV.VOC12ClsDataset(**kw), JV.VOC12ClsDataset(**kw))
    kw["rescale_range"] = None
    _same_items(TV.VOC12ClsDataset(**kw), JV.VOC12ClsDataset(**kw))


@pytest.mark.parametrize("aug", [True, False])
@pytest.mark.parametrize("family", ["voc", "coco"])
def test_seg_dataset(family, aug):
    kw = dict(crop_size=64, num_classes=21 if family == "voc" else 81, aug=aug, seed=5,
              synthetic_n=6)
    mod_t, mod_j = (TV, JV) if family == "voc" else (TC, JC)
    name = "VOC12SegDataset" if family == "voc" else "CocoSegDataset"
    _same_items(getattr(mod_t, name)(**kw), getattr(mod_j, name)(**kw), range(6))


@pytest.mark.parametrize("canvas", [64, 128, 160])
@pytest.mark.parametrize("family", ["voc", "coco"])
def test_raw_canvas_dataset(family, canvas):
    """The raw uint8 canvases of the on-device chain (96 x 128 synthetic images:
    a 64 canvas cuts them, 128 holds them exactly, 160 pads them)."""
    mod_t, mod_j = (TV, JV) if family == "voc" else (TC, JC)
    name = "VOC12ClsRawDataset" if family == "voc" else "CocoClsRawDataset"
    kw = dict(canvas_size=canvas, synthetic_n=4)
    t, j = getattr(mod_t, name)(**kw), getattr(mod_j, name)(**kw)
    _same_items(t, j)
    _, img, hw, _ = t[0]
    assert img.shape == (canvas, canvas, 3) and img.flags["C_CONTIGUOUS"]
    assert tuple(hw) == (min(96, canvas), min(128, canvas))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_loader_two_epochs(shuffle, drop_last):
    """Seven samples in batches of 3: two epochs reshuffled from seed + epoch,
    the short batch dropped or kept."""
    kw = dict(crop_size=48, synthetic_n=7, synthetic_size=(40, 56))
    t_ds, j_ds = TV.VOC12ClsDataset(**kw), JV.VOC12ClsDataset(**kw)
    per_epoch = 2 if drop_last else 3
    t_it = iter(TV.BatchLoader(t_ds, 3, shuffle=shuffle, seed=11, drop_last=drop_last))
    j_it = iter(JV.BatchLoader(j_ds, 3, shuffle=shuffle, seed=11, drop_last=drop_last))
    names = []
    for _ in range(2 * per_epoch):
        got, want = next(t_it), next(j_it)
        _same(got, want)
        assert isinstance(got, tuple) and len(got) == 4 and isinstance(got[0], list)
        names.append(got[0])
    first, second = names[:per_epoch], names[per_epoch:]
    if not drop_last:   # each epoch visits every sample once
        assert sorted(sum(first, [])) == sorted(sum(second, [])) == sorted(
            f"synthetic_{i:06d}" for i in range(7))
    assert (first != second) == shuffle


def test_batch_loader_without_loop():
    kw = dict(canvas_size=64, synthetic_n=5)
    got = list(TV.BatchLoader(TV.VOC12ClsRawDataset(**kw), 2, seed=1, loop=False))
    want = list(JV.BatchLoader(JV.VOC12ClsRawDataset(**kw), 2, seed=1, loop=False))
    assert len(got) == len(want) == 2
    _same(got, want)


@pytest.mark.parametrize("n,k,fold", [(25, 10, -1), (25, 10, 0), (25, 10, 3), (7, 3, 4),
                                      (100, 5, 2)])
def test_kfold_indices(n, k, fold):
    _same(TV.kfold_indices(n, k, fold), JV.kfold_indices(n, k, fold))
    _same(TV.kfold_indices(n, k, fold, seed=5), JV.kfold_indices(n, k, fold, seed=5))


def _write_tree(root, family):
    """A tiny dataset tree: two RGB JPEGs (one with its PNG mask), one grayscale
    JPEG for COCO's grayscale fix, and the name list."""
    rng = np.random.default_rng(0)
    sub = "" if family == "voc" else "train2014"
    img_dir = root / "JPEGImages" / sub
    lab_dir = root / ("SegmentationClassAug" if family == "voc" else "SegmentationClass") / sub
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    names = ["a_001", "b_002", "c_003"]
    for i, name in enumerate(names):
        if i == 2 and family == "coco":
            Image.fromarray(rng.integers(0, 256, (30, 44)).astype(np.uint8), "L").save(
                img_dir / f"{name}.jpg")
        else:
            Image.fromarray(rng.integers(0, 256, (30, 44, 3)).astype(np.uint8)).save(
                img_dir / f"{name}.jpg")
        if i != 1:
            Image.fromarray(rng.choice([0, 4, 15, 255], (30, 44)).astype(np.uint8)).save(
                lab_dir / f"{name}.png")
    lists = root / "lists"
    lists.mkdir()
    split = "train_aug" if family == "voc" else "train"
    (lists / f"{split}.txt").write_text("".join(f"{n} extra\n" for n in names) + "\n")
    return str(root), str(lists), split


@pytest.mark.parametrize("family", ["voc", "coco"])
def test_filesystem_sources(tmp_path, family):
    root, lists, split = _write_tree(tmp_path, family)
    if family == "voc":
        t, j = TV.make_source(root, lists, split), JV.make_source(root, lists, split)
        assert isinstance(t, TV.VOC12Source)
    else:
        t, j = TC.make_coco_source(root, lists, split), JC.make_coco_source(root, lists, split)
        assert isinstance(t, TC.CocoSource)
    assert len(t) == len(j) == 3
    for i in range(3):
        _same(t.get(i), j.get(i))
    assert t.get(1)[2].max() == 0            # no mask: zeros
    assert t.get(2)[1].shape == (30, 44, 3)  # COCO stacks a grayscale image to RGB
    kw = dict(root_dir=root, name_list_dir=lists, split=split, crop_size=32, seed=2)
    cls_t = TV.VOC12ClsDataset if family == "voc" else TC.CocoClsDataset
    cls_j = JV.VOC12ClsDataset if family == "voc" else JC.CocoClsDataset
    _same_items(cls_t(**kw), cls_j(**kw), range(3))


def test_missing_tree_falls_back_to_the_synthetic_source(tmp_path):
    for make in (TV.make_source, TC.make_coco_source):
        assert isinstance(make(str(tmp_path), None), TV.SyntheticSegSource)
        assert isinstance(make(None, None), TV.SyntheticSegSource)


def test_robust_read_image(tmp_path):
    gray = np.arange(12 * 9, dtype=np.uint8).reshape(12, 9)
    Image.fromarray(gray, "L").save(tmp_path / "g.png")
    Image.fromarray(np.dstack([gray] * 4), "RGBA").save(tmp_path / "a.png")
    for name in ("g.png", "a.png"):
        _same(TC.robust_read_image(str(tmp_path / name)),
              JC.robust_read_image(str(tmp_path / name)))
    assert TC.robust_read_image(str(tmp_path / "a.png")).shape == (12, 9, 3)


def test_registry_names():
    names = {"voc12_cls", "voc12_cls_raw", "voc12_seg", "coco_cls", "coco_cls_raw", "coco_seg"}
    assert names <= set(J_DATASETS.keys()) and names <= set(T_DATASETS.keys())
    for name in names:
        cls = T_DATASETS.get(name)
        assert cls.__module__.startswith("representationlearning_tpu_torch.data.")
        assert cls.__name__ == J_DATASETS.get(name).__name__
    ds = T_DATASETS.build("voc12_cls", crop_size=48, synthetic_n=2)
    _same(ds[1], JV.VOC12ClsDataset(crop_size=48, synthetic_n=2)[1])
