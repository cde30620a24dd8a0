"""COCO annotations -> VOC-style class/instance/id masks, the port's copy of
``representationlearning_tpu/convert/coco2voc.py`` (parity with
`SCD-AAAI2023/coco2voc/coco2voc.py:9-77`, without pycocotools: COCO-format JSON is
parsed directly, polygon segmentations rasterize via PIL, and both uncompressed and
compressed RLE decode in numpy).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE (LEB128-style varint string) -> (h, w) mask (column-major)."""
    cnts = []
    i = 0
    b = counts.encode("ascii") if isinstance(counts, str) else counts
    while i < len(b):
        x = 0
        k = 0
        more = True
        while more:
            c = b[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    vals = np.zeros(sum(cnts), np.uint8)
    pos = 0
    val = 0
    for c in cnts:
        vals[pos : pos + c] = val
        pos += c
        val = 1 - val
    return vals.reshape(w, h).T  # column-major


def decode_uncompressed_rle(counts, h: int, w: int) -> np.ndarray:
    vals = np.zeros(sum(counts), np.uint8)
    pos = 0
    val = 0
    for c in counts:
        vals[pos : pos + c] = val
        pos += c
        val = 1 - val
    return vals.reshape(w, h).T


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """pycocotools annToMask equivalent."""
    seg = ann["segmentation"]
    if isinstance(seg, list):  # polygons
        from PIL import Image, ImageDraw

        img = Image.new("L", (w, h), 0)
        draw = ImageDraw.Draw(img)
        for poly in seg:
            pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
            if len(pts) >= 3:
                draw.polygon(pts, outline=1, fill=1)
        return np.asarray(img, np.uint8)
    counts = seg["counts"]
    if isinstance(counts, list):
        return decode_uncompressed_rle(counts, seg["size"][0], seg["size"][1])
    return decode_compressed_rle(counts, seg["size"][0], seg["size"][1])


def coco2voc(anns_file: str, target_folder: str, n: int | None = None,
             compress: bool = True, category_map: dict | None = None):
    """Produce class/instance/id masks per image (`coco2voc.py:9-77` semantics:
    class = category per pixel, instance = per-instance index, id = annotation id)."""
    with open(anns_file) as f:
        coco = json.load(f)
    imgs = {im["id"]: im for im in coco["images"]}
    anns_by_img = defaultdict(list)
    for a in coco["annotations"]:
        anns_by_img[a["image_id"]].append(a)

    class_dir = os.path.join(target_folder, "class_labels")
    inst_dir = os.path.join(target_folder, "instance_labels")
    id_dir = os.path.join(target_folder, "id_labels")
    for d in (class_dir, inst_dir, id_dir):
        os.makedirs(d, exist_ok=True)

    ids_converted = []
    for i, (img_id, img) in enumerate(imgs.items()):
        if n is not None and i >= n:
            break
        h, w = img["height"], img["width"]
        class_mask = np.zeros((h, w), np.int32)
        inst_mask = np.zeros((h, w), np.int32)
        id_mask = np.zeros((h, w), np.int64)
        for k, ann in enumerate(anns_by_img.get(img_id, []), start=1):
            m = ann_to_mask(ann, h, w).astype(bool)
            cat = ann["category_id"]
            if category_map:
                cat = category_map.get(cat, 0)
            class_mask[m] = cat
            inst_mask[m] = k
            id_mask[m] = ann["id"]
        base = str(img_id)
        save = np.savez_compressed if compress else np.savez
        save(os.path.join(class_dir, base), class_mask)
        save(os.path.join(inst_dir, base), inst_mask)
        save(os.path.join(id_dir, base), id_mask)
        ids_converted.append(img_id)

    with open(os.path.join(target_folder, "images_ids.txt"), "a+") as f:
        for i in ids_converted:
            f.write(f"{i}\n")
    return ids_converted
