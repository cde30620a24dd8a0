"""Events, visualisation and the input pipeline of the PyTorch port
(`utils/events.py`, `utils/visualize.py`, `data/prefetch.py`) against the JAX
package's: visualisations with equal bits, `scalars.csv` byte for byte, each PNG
the port writes (without Pillow) decoding through Pillow to the pixels of JAX's
file; the threaded loader's order and errors; `device_prefetch`'s order and
device (tolerance: none)."""
import itertools
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from representationlearning_tpu.utils import events as JE
from representationlearning_tpu.utils import visualize as JV
from representationlearning_tpu_torch.data import prefetch as TP
from representationlearning_tpu_torch.utils import events as TE
from representationlearning_tpu_torch.utils import visualize as TV


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,normalized", [(256, False), (256, True), (21, False), (7, True)])
def test_colormap(N, normalized):
    _same(TV.colormap(N, normalized), JV.colormap(N, normalized))


def test_encode_cmap_and_jet():
    rng = np.random.default_rng(0)
    label = rng.choice([0, 1, 5, 20, 255, 300], (13, 17))
    _same(TV.encode_cmap(label), JV.encode_cmap(label))
    v = np.concatenate([rng.uniform(-0.5, 1.5, 198), np.linspace(0, 1, 33)]).reshape(-1, 11)
    _same(TV.jet(v), JV.jet(v))


@pytest.mark.parametrize("cam_hw", [(24, 32), (12, 16), (7, 9)])
def test_cam_overlay(cam_hw):
    """At the images' size (no resize) and smaller (Pillow's bilinear resize)."""
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((3, 24, 32, 3)).astype(np.float32)
    cams = rng.uniform(0, 1, (3,) + cam_hw + (4,)).astype(np.float32)
    for alpha in (0.5, 0.3):
        _same(TV.cam_overlay(imgs, cams, alpha), JV.cam_overlay(imgs, cams, alpha))


@pytest.mark.parametrize("n,nrow,pad", [(1, 2, 2), (4, 2, 2), (5, 3, 0), (3, 4, 1)])
def test_make_grid(n, nrow, pad):
    imgs = np.random.default_rng(n).integers(0, 256, (n, 9, 11, 3)).astype(np.uint8)
    _same(TV.make_grid(imgs, nrow, pad), JV.make_grid(imgs, nrow, pad))
    floats = imgs.astype(np.float32) / 255.0
    _same(TV.make_grid(floats, nrow, pad), JV.make_grid(floats, nrow, pad))


def test_attention_grid():
    attn = np.random.default_rng(2).uniform(0, 1, (3, 36, 36)).astype(np.float32)
    for q, size in ((0, (112, 112)), (17, (20, 30))):
        _same(TV.attention_grid(attn, q, size), JV.attention_grid(attn, q, size))


def test_save_palette_png(tmp_path):
    label = np.random.default_rng(3).choice([0, 2, 7, 255], (15, 21))
    pal = np.random.default_rng(4).integers(0, 256, (256, 3))
    for palette in (None, pal):
        TV.save_palette_png(label, str(tmp_path / "t.png"), palette)
        JV.save_palette_png(label, str(tmp_path / "j.png"), palette)
        t, j = Image.open(tmp_path / "t.png"), Image.open(tmp_path / "j.png")
        assert t.mode == j.mode == "P" and t.getpalette() == j.getpalette()
        _same(np.asarray(t), np.asarray(j))


def _read_palette_png(path):
    """(indices (H, W), palette (n, 3)) of an 8-bit palette PNG written with
    filter 0, read with zlib alone."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    assert chunks[b"IHDR"][8:10] == bytes([8, 3])   # depth 8, colour type 3
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:], np.frombuffer(chunks[b"PLTE"], np.uint8).reshape(-1, 3)


@pytest.mark.parametrize("palette", ["default", "random", "short"])
def test_save_palette_png_without_pillow(tmp_path, monkeypatch, palette):
    """With Pillow hidden the palette PNG is written all the same; read back with
    zlib it holds the labels as indices and the palette as given, and Pillow (where
    installed) reads the JAX package's file of the same labels as the same."""
    label = np.random.default_rng(6).choice([0, 3, 6, 255], (13, 17))
    pal = {"default": None, "random": np.random.default_rng(7).integers(0, 256, (256, 3)),
           "short": np.array([[255, 255, 255], [255, 0, 0], [0, 0, 255]])}[palette]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        m.setitem(sys.modules, "PIL.Image", None)
        TV.save_palette_png(label, str(tmp_path / "t.png"), pal)
    index, got_pal = _read_palette_png(tmp_path / "t.png")
    want_pal = TV.colormap() if pal is None else np.asarray(pal, np.uint8)
    np.testing.assert_array_equal(index, label.astype(np.uint8))
    np.testing.assert_array_equal(got_pal, want_pal)
    if palette != "short":   # Pillow pads a short palette of the JAX file itself
        JV.save_palette_png(label, str(tmp_path / "j.png"), pal)
        j = Image.open(tmp_path / "j.png")
        np.testing.assert_array_equal(np.asarray(j), index)
        assert j.getpalette() == got_pal.reshape(-1).tolist()
    t = Image.open(tmp_path / "t.png")
    assert t.mode == "P" and t.getpalette()[:len(got_pal) * 3] == got_pal.reshape(-1).tolist()


def test_palette_png_writer_refuses_other_layouts(tmp_path):
    with pytest.raises(ValueError, match="takes"):
        TE.write_png_palette(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8),
                             TV.colormap())
    with pytest.raises(ValueError, match="palette entry"):
        TE.write_png_palette(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8), [])


def _log_both(tmp_path, fn):
    for pkg, name in ((TE, "t"), (JE, "j")):
        w = pkg.MetricsWriter(str(tmp_path / name), tensorboard=False)
        fn(w)
        w.close()


def test_scalars_csv_identical(tmp_path):
    def log(w):
        w.add_scalar("train/cls", 0.25, 1)
        w.add_scalars({"seg": np.float32(1.5), "er": 1e-9, "nan": float("nan")}, 2,
                      prefix="train/")
        w.add_scalar("val/seg_miou", torch.tensor(0.125), 3)
        w.flush()

    _log_both(tmp_path, log)
    _log_both(tmp_path, log)   # reopened: appended, no second header
    t = (tmp_path / "t" / "scalars.csv").read_bytes()
    assert t == (tmp_path / "j" / "scalars.csv").read_bytes()
    assert t.count(b"step,tag,value") == 1 and t.count(b"val/seg_miou") == 2


@pytest.mark.parametrize("kind", ["float", "uint8", "label", "tiny"])
def test_png_pixels_equal_jax(tmp_path, kind):
    rng = np.random.default_rng(5)
    image = {"float": rng.uniform(-0.2, 1.2, (19, 23, 3)).astype(np.float32),
             "uint8": rng.integers(0, 256, (40, 3, 3)).astype(np.uint8),
             "label": rng.integers(0, 256, (17, 29)).astype(np.uint8),
             "tiny": np.full((1, 1, 3), 0.5)}[kind]
    _log_both(tmp_path, lambda w: w.add_image("val/img", image, 42))
    name = "val_img_0000042.png"
    t = Image.open(tmp_path / "t" / "images" / name)
    j = Image.open(tmp_path / "j" / "images" / name)
    assert t.mode == j.mode == "RGB"
    _same(np.asarray(t), np.asarray(j))
    assert sorted(os.listdir(tmp_path / "t" / "images")) == [name]


def test_png_writer_refuses_other_layouts(tmp_path):
    with pytest.raises(ValueError, match="takes"):
        TE.write_png_rgb(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))


def test_tensorboard_mirror(tmp_path):
    """With the tensorboard package importable, scalars and images are mirrored
    into event files beside the CSV and the PNGs."""
    pytest.importorskip("torch.utils.tensorboard")
    w = TE.MetricsWriter(str(tmp_path))
    if w._tb is None:
        pytest.skip("tensorboard's writer is not available")
    w.add_scalar("train/cls", 0.5, 1)
    w.add_image("val/seg_pred", np.zeros((8, 8, 3), np.float32), 1)
    w.close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))
    assert (tmp_path / "images" / "val_seg_pred_0000001.png").exists()


def test_threaded_loader_keeps_order():
    src = [(i, np.full((2, 3), i)) for i in range(23)]
    for depth in (1, 4, 64):
        got = list(TP.ThreadedLoader(src, depth=depth))
        assert [g[0] for g in got] == list(range(23))
        assert all((g[1] == i).all() for i, g in enumerate(got))
    first = list(itertools.islice(TP.ThreadedLoader(itertools.count()), 5))
    assert first == [0, 1, 2, 3, 4]


def test_threaded_loader_reraises_worker_errors():
    def gen():
        yield 1
        yield 2
        raise KeyError("sample 3")

    it = iter(TP.ThreadedLoader(gen(), depth=2))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="sample 3"):
        next(it)


@pytest.mark.parametrize("n", [1, 2, 5, 50])
def test_device_prefetch_keeps_order_and_device(n):
    items = [{"image": np.full((2, 3), i, np.float32), "ids": torch.tensor([i]),
              "names": [f"s{i}"], "pair": (np.int32(i), np.arange(i + 1))} for i in range(7)]
    got = list(TP.device_prefetch(iter(items), n=n, device="cpu"))
    assert len(got) == 7
    for i, g in enumerate(got):
        assert isinstance(g["image"], torch.Tensor) and g["image"].device.type == "cpu"
        assert (g["image"] == i).all() and int(g["ids"]) == i and g["names"] == [f"s{i}"]
        assert isinstance(g["pair"], tuple) and torch.equal(g["pair"][1], torch.arange(i + 1))
    assert list(TP.device_prefetch([], device="cpu")) == []


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TP.device_prefetch([np.zeros(2)]))
