"""The port's LoveDA data (`data/loveda.py`) against the JAX package's: the maps, the
synthetic source, files read from directories, the host train chain (crop, OneOf
flip / rot90, cv2's ShiftScaleRotate, normalise), eval samples, the raw canvases
of the on-device chain and `collate_loveda`, all with equal bits; the registry
name (tolerance: none)."""
import numpy as np
import pytest
import torch
from PIL import Image

from representationlearning_tpu.core.registry import DATASETS as J_DATASETS
from representationlearning_tpu.data import loveda as JL
from representationlearning_tpu_torch.core.registry import DATASETS
from representationlearning_tpu_torch.data import loveda as TL

torch.set_num_threads(2)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_maps_and_registry():
    assert TL.COLOR_MAP == JL.COLOR_MAP and list(TL.COLOR_MAP) == list(JL.COLOR_MAP)
    assert TL.LABEL_MAP == JL.LABEL_MAP and list(TL.LABEL_MAP) == list(JL.LABEL_MAP)
    assert TL.NUM_LOVEDA_CLASSES == JL.NUM_LOVEDA_CLASSES == 7
    assert DATASETS.get("LoveDALoader") is TL.LoveDADataset
    assert "LoveDALoader" in J_DATASETS
    ds = DATASETS.build("LoveDALoader", training=False, synthetic_n=3)
    assert len(ds) == 3


@pytest.mark.parametrize("kw", [
    dict(training=True, crop_size=64, seed=0),
    dict(training=True, crop_size=160, seed=2333),                 # larger than the images
    dict(training=True, crop_size=48, seed=5, affine_p=1.0, flip_rot_p=1.0, scale_limit=0.3),
    dict(training=False),
    dict(training=True, synthetic_size=(96, 120), crop_size=64, seed=1),
])
def test_dataset_samples_match_jax(kw):
    port, jax_ds = TL.LoveDADataset(synthetic_n=12, **kw), JL.LoveDADataset(synthetic_n=12, **kw)
    assert len(port) == len(jax_ds) == 12
    for i in range(12):
        (pn, pimg, pmask), (jn, jimg, jmask) = port[i], jax_ds[i]
        assert pn == jn
        _same(pimg, jimg)
        _same(pmask, jmask)


def test_raw_canvases_match_jax():
    """raw=True: the (3, S, S) uint8 canvas, the true (h, w) and the (S, S) int32
    mask canvas filled with -1, cut where the image is larger than the canvas."""
    for size, canvas in (((128, 128), 160), ((96, 120), 100)):
        kw = dict(raw=True, canvas_size=canvas, synthetic_n=5, synthetic_size=size)
        port, jax_ds = TL.LoveDADataset(**kw), JL.LoveDADataset(**kw)
        for i in range(5):
            (pn, pc, phw, pm), (jn, jc, jhw, jm) = port[i], jax_ds[i]
            assert pn == jn and pc.dtype == torch.uint8 and phw.dtype == pm.dtype == torch.int32
            _same(pc.numpy(), jc.transpose(2, 0, 1))
            _same(phw.numpy(), jhw)
            _same(pm.numpy(), jm)
            assert (pm.numpy()[min(size[0], canvas):] == -1).all()


def test_collate_matches_jax():
    kw = dict(training=True, crop_size=64, synthetic_n=6)
    samples_t = [TL.LoveDADataset(**kw)[i] for i in (3, 0, 5)]
    samples_j = [JL.LoveDADataset(**kw)[i] for i in (3, 0, 5)]
    got, want = TL.collate_loveda(samples_t), JL.collate_loveda(samples_j)
    assert got[0] == want[0]
    _same(got[1], want[1])
    _same(got[2], want[2])


def test_files_on_disk_match_jax(tmp_path):
    """`LoveDASource` over two image directories, masks stored 1..7 (0 the
    ignore), one image without a mask; the dataset picks it over the synthetic
    source when a directory exists."""
    rng = np.random.default_rng(4)
    dirs = []
    for region in ("Urban", "Rural"):
        idir, mdir = tmp_path / region / "images_png", tmp_path / region / "masks_png"
        idir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        for n in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)).save(
                idir / f"{region}{n}.png")
            if n < 2:
                Image.fromarray(rng.integers(0, 8, (40, 52)).astype(np.uint8)).save(
                    mdir / f"{region}{n}.png")
        dirs.append((str(idir), str(mdir)))
    images, masks = [d[0] for d in dirs], [d[1] for d in dirs]
    for kw in (dict(training=False), dict(training=True, crop_size=32, seed=3),
               dict(raw=True, canvas_size=64)):
        port = TL.LoveDADataset(image_dir=images, mask_dir=masks, **kw)
        jax_ds = JL.LoveDADataset(image_dir=images, mask_dir=masks, **kw)
        assert isinstance(port.source, TL.LoveDASource) and len(port) == len(jax_ds) == 6
        for i in range(6):
            for g, w in zip(port[i], jax_ds[i]):
                if isinstance(g, str):
                    assert g == w
                elif isinstance(g, torch.Tensor):
                    _same(g.numpy(), w.transpose(2, 0, 1) if g.ndim == 3 else w)
                else:
                    _same(g, w)
    name, img, mask = TL.LoveDASource(images[0], masks[0]).get(2)
    assert name == "Urban2.png" and (mask == -1).all() and img.shape == (40, 52, 3)
