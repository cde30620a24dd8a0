"""COCO annotations to VOC-style masks in the PyTorch port (`convert/coco2voc.py`)
against the JAX package's: both RLE decoders, polygons, and `coco2voc` on a small
COCO-format JSON give equal arrays (tolerance: none)."""
import json

import numpy as np
import pytest

from representationlearning_tpu.convert import coco2voc as J
from representationlearning_tpu_torch.convert import coco2voc as T
from representationlearning_tpu_torch.data.coco import COCO_CATEGORY_MAP


def _rle_string(cnts):
    """COCO's compressed RLE encoding (pycocotools `rleToString`): each count,
    less the count two before it from the fourth on, as 5-bit groups + 48."""
    out = []
    for i, x in enumerate(cnts):
        x = int(x) - (int(cnts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def _counts(mask):
    """Column-major run lengths of a binary mask, starting with a run of 0s."""
    flat = mask.T.reshape(-1)
    cnts, val, run = [], 0, 0
    for v in flat:
        if v == val:
            run += 1
        else:
            cnts.append(run)
            val, run = v, 1
    cnts.append(run)
    return cnts


def _mask(seed, h, w):
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(3):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y:y + rng.integers(1, h + 1), x:x + rng.integers(1, w + 1)] = 1
    return m


@pytest.mark.parametrize("seed,h,w", [(0, 7, 9), (1, 31, 17), (2, 64, 80), (3, 1, 1),
                                      (4, 200, 150)])
def test_rle_decoders(seed, h, w):
    m = _mask(seed, h, w)
    cnts = _counts(m)
    got_u, want_u = T.decode_uncompressed_rle(cnts, h, w), J.decode_uncompressed_rle(cnts, h, w)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_u, m)
    s = _rle_string(cnts)
    for counts in (s, s.encode("ascii")):
        got, want = T.decode_compressed_rle(counts, h, w), J.decode_compressed_rle(counts, h, w)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, m)


def _anns(h, w):
    big = _mask(5, h, w)
    return [
        {"id": 11, "category_id": 18,
         "segmentation": [[2.0, 3.0, 20.5, 4.0, 15.0, 25.0, 3.0, 20.0],
                          [30, 30, 38, 31, 35, 39]]},
        {"id": 12, "category_id": 1, "segmentation": {"size": [h, w], "counts": _counts(big)}},
        {"id": 13, "category_id": 90,
         "segmentation": {"size": [h, w], "counts": _rle_string(_counts(_mask(6, h, w)))}},
        {"id": 14, "category_id": 44, "segmentation": [[1, 1, 5, 5]]},   # under 3 points
    ]


def test_ann_to_mask():
    h, w = 41, 47
    for ann in _anns(h, w):
        got, want = T.ann_to_mask(ann, h, w), J.ann_to_mask(ann, h, w)
        assert got.dtype == want.dtype and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
    assert T.ann_to_mask(_anns(h, w)[0], h, w).sum() > 0


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("mapped", [True, False])
@pytest.mark.parametrize("n", [None, 2])
def test_coco2voc(tmp_path, compress, mapped, n):
    images = [{"id": 7, "height": 41, "width": 47}, {"id": 3, "height": 20, "width": 30},
              {"id": 9, "height": 41, "width": 47}]
    anns = [dict(a, image_id=7) for a in _anns(41, 47)]
    anns.append({"id": 21, "image_id": 9, "category_id": 62,
                 "segmentation": [[0, 0, 40, 2, 20, 30]]})
    path = tmp_path / "anns.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    cmap = COCO_CATEGORY_MAP if mapped else None
    got = T.coco2voc(str(path), str(tmp_path / "t"), n=n, compress=compress, category_map=cmap)
    want = J.coco2voc(str(path), str(tmp_path / "j"), n=n, compress=compress, category_map=cmap)
    assert got == want == ([7, 3, 9] if n is None else [7, 3])
    for kind in ("class_labels", "instance_labels", "id_labels"):
        for i in got:
            a = np.load(tmp_path / "t" / kind / f"{i}.npz")["arr_0"]
            b = np.load(tmp_path / "j" / kind / f"{i}.npz")["arr_0"]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert (tmp_path / "t" / "images_ids.txt").read_text() == \
        (tmp_path / "j" / "images_ids.txt").read_text()
    cls = np.load(tmp_path / "t" / "class_labels" / "7.npz")["arr_0"]
    cats = (18, 1, 90, 44)
    assert set(np.unique(cls)) - {0} <= {COCO_CATEGORY_MAP[c] if mapped else c for c in cats}
    assert len(set(np.unique(cls)) - {0}) >= 2
