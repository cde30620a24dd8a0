"""WaveCAM's IRN stages of the PyTorch port's pipeline (`wsss/wavecam_pipeline.py`)
against the JAX package's, at the JAX tests' tiny configuration
(`wavecam_pipeline_common.TINY`) with the CRF's permutohedral lattice
(`crf_method="native"`: JAX's grid CRF takes 10 s a pass here, and the grid itself
is held in tests/test_torch_crf.py), on the same files:

- CAM dicts made from the synthetic masks (blurred discs of the present classes
  and noise), the same files for both packages;
- `cam_to_ir_label`: the labels equal except where one of JAX's two CRF passes
  has its two best Q within 1e-3;
- the IRN samples: crops bit-equal, the x0.25 nearest reduction equal to what
  Pillow gave JAX, the affinity labels equal;
- `train_irn` from the same initial weights (JAX's, calmed) on JAX's IR labels:
  every saved tensor within 1e-4 of its largest entry, the frozen backbone that
  the weight decay moves and `dp_running_mean` included (the worst is printed);
- `make_sem_seg_labels` on JAX's `irn.npy`: the labels equal except where the
  port's two best scores are within 1e-3; `eval_sem_seg` on the same files within
  1e-6;
- `resize_nearest_pil` equal to Pillow's NEAREST over a range of sizes;
- the COCO-shaped source branch end to end on a `tmp_path` tree (as
  tests/test_wavecam_pipeline.py runs it for JAX).

JAX's stages run once, in a module-scoped fixture."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.data import transforms as JT
from representationlearning_tpu.models import irn as JI
from representationlearning_tpu.ops import crf as JC
from representationlearning_tpu.wsss import indexing as JX
from representationlearning_tpu.wsss import wavecam_pipeline as JP
from representationlearning_tpu_torch.convert.from_jax import irn_state_dict_from_jax
from representationlearning_tpu_torch.data.voc import cls_onehot_from_mask
from representationlearning_tpu_torch.wsss import wavecam_infer as TW
from representationlearning_tpu_torch.wsss import wavecam_pipeline as TP
from representationlearning_tpu_torch.wsss.indexing import GetAffinityLabelFromIndices, PathIndex
from wavecam_pipeline_common import TINY, hold, numpy_sd, port, recorder, save_weights

torch.set_num_threads(2)

WEIGHT_TOL = 1e-4
NEAR = 1e-3
MIOU_TOL = 1e-6
IRN = dict(TINY, crf_method="native")


def _cam_dict(mask, n_classes, seed):
    """A dict like make_cam's: each present class's disc blurred (a 5 x 5 box,
    twice) plus noise, max-normalised; the strided CAMs every fourth pixel."""
    rng = np.random.default_rng(seed)
    keys = np.nonzero(cls_onehot_from_mask(mask, n_classes + 1))[0]
    high = []
    for k in keys:
        m = (mask == k + 1).astype(np.float32)
        for _ in range(2):
            p = np.pad(m, 2, mode="edge")
            m = sum(p[i:i + mask.shape[0], j:j + mask.shape[1]] for i in range(5)
                    for j in range(5)) / 25.0
        m = m + 0.15 * rng.random(m.shape, dtype=np.float32)
        high.append(m / m.max())
    high = np.stack(high).astype(np.float32)
    return {"keys": keys, "cam": np.ascontiguousarray(high[:, ::4, ::4]), "high_res": high}


def _write_cams(pipe, source):
    for idx in range(len(source)):
        name, _, mask = source.get(idx)
        np.save(os.path.join(pipe.cfg.dir("cam"), name + ".npy"),
                _cam_dict(mask, TINY["n_classes"], idx), allow_pickle=True)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("jax_wavecam_irn"))
    init, crf_near, reduced = {}, {}, []

    def crf_label(img, labels_map, n_labels=21, method="grid"):
        """JAX's `crf_inference_label`, keeping where its two best Q are near."""
        u = JC.unary_from_labels(jnp.asarray(labels_map), n_labels, 0.7)
        q = np.asarray(JC.mean_field_inference(
            jnp.asarray(img, jnp.float32), u, t=10, sxy_g=3.0, compat_g=3.0, sxy_b=50.0,
            srgb_b=5.0, compat_b=10.0, method=method))
        s = np.sort(q, axis=-1)
        key = img.tobytes()
        crf_near[key] = crf_near.get(key, False) | ((s[..., -1] - s[..., -2]) < NEAR)
        return q.argmax(-1)

    class Labeler(JX.GetAffinityLabelFromIndices):
        def __call__(self, segm_map):
            reduced.append(np.array(segm_map))
            return super().__call__(segm_map)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "crf_inference_label", crf_label)
        mp.setattr(JP, "GetAffinityLabelFromIndices", Labeler)
        mp.setattr(JP, "IRNNet", recorder(JI.IRNNet, init, "irn", seed=3))
        pipe = JP.WaveCAMPipeline(JP.WaveCAMConfig(work_dir=work, **IRN))
        _write_cams(pipe, pipe.source)
        res = pipe.run(["cam_to_ir_label", "train_irn", "make_sem_seg", "eval_sem_seg"])
    near = {}
    for idx in range(len(pipe.source)):
        name, img, _ = pipe.source.get(idx)
        near[name] = crf_near[img.tobytes()]
    irn = np.load(os.path.join(work, "weights", "irn.npy"), allow_pickle=True).item()
    return dict(work=work, pipe=pipe, init=init["irn"], near=near, reduced=reduced, irn=irn,
                eval_sem_seg=res["eval_sem_seg"])


def _copy_dir(jax_run, pipe, sub):
    shutil.copytree(os.path.join(jax_run["work"], sub), pipe.cfg.dir(sub), dirs_exist_ok=True)


def test_cam_to_ir_label_matches_jax(jax_run, tmp_path):
    pipe = port(tmp_path, crf_method="native")
    _copy_dir(jax_run, pipe, "cam")
    pipe.run(["cam_to_ir_label"])
    seen = set()
    for name, near in jax_run["near"].items():
        got = np.load(os.path.join(pipe.cfg.dir("ir_label"), name + ".npy"))
        want = np.load(os.path.join(jax_run["work"], "ir_label", name + ".npy"))
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        assert not ((got != want) & ~near).any(), name
        assert near.mean() < 0.05
        seen |= set(np.unique(want).tolist())
    assert {0, 255} <= seen and len(seen) > 2   # background, unsure and classes


def test_irn_samples_equal_jax(jax_run, tmp_path):
    """The crops as JAX's `train_irn` makes them (`:325-338`, with JAX's own
    transforms), and the reductions Pillow gave it."""
    cfg = jax_run["pipe"].cfg
    pipe = port(tmp_path, crf_method="native")
    _copy_dir(jax_run, pipe, "ir_label")
    feat = cfg.irn_crop_size // 4
    pidx = PathIndex(radius=cfg.irn_radius, default_size=(feat, feat))
    samples = pipe.irn_samples(feat, GetAffinityLabelFromIndices(pidx.src_indices,
                                                                  pidx.dst_indices))
    jlab = JX.GetAffinityLabelFromIndices(pidx.src_indices, pidx.dst_indices)
    assert len(samples) == len(jax_run["reduced"]) == cfg.synthetic_n
    for idx, (sample, reduced) in enumerate(zip(samples, jax_run["reduced"])):
        name, img, _ = jax_run["pipe"].source.get(idx)
        lab = np.load(os.path.join(cfg.dir("ir_label"), name + ".npy"))
        rng = np.random.default_rng((cfg.seed << 12) ^ idx)
        im, _, _ = JT.random_crop(rng, img.astype(np.float32), lab, crop_size=cfg.irn_crop_size,
                                  mean_rgb=(0, 0, 0), ignore_index=255)
        np.testing.assert_array_equal(sample[0], JT.normalize_img(im))
        for got, want in zip(sample[1:], jlab(reduced), strict=True):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert any((r == 255).any() for r in jax_run["reduced"])


def test_train_irn_matches_jax(jax_run, tmp_path, monkeypatch):
    start = numpy_sd(irn_state_dict_from_jax(jax_run["init"]))
    IRNNet = TP.IRNNet
    monkeypatch.setattr(TP, "IRNNet", lambda **kw: TP._load_state(IRNNet(**kw), start))
    pipe = port(tmp_path, crf_method="native")
    _copy_dir(jax_run, pipe, "ir_label")
    pipe.run(["train_irn"])
    got = pipe._load("irn.npy")
    hold(got, numpy_sd(irn_state_dict_from_jax(jax_run["irn"])), WEIGHT_TOL, "train_irn")
    # the backbone is frozen, yet the weight decay and the momentum moved it, as in
    # JAX; its statistics stayed; the mean shift was calibrated
    moved = lambda k: not np.array_equal(got[k], start[k])
    assert moved("resnet50.layer4.2.conv3.weight") and moved("resnet50.bn1.bias")
    assert moved("fc_edge6.weight") and moved("mean_shift.running_mean")
    assert not moved("resnet50.bn1.running_var")


def test_make_sem_seg_and_eval_match_jax(jax_run, tmp_path):
    pipe = port(tmp_path, crf_method="native")
    _copy_dir(jax_run, pipe, "cam")
    save_weights(pipe, "irn.npy", numpy_sd(irn_state_dict_from_jax(jax_run["irn"])))
    pipe.run(["make_sem_seg"])
    model = TP._load_state(TP.IRNNet(device="cpu"), pipe._load("irn.npy")).eval()
    seen = set()
    for idx in range(len(pipe.source)):
        name, img, _ = pipe.source.get(idx)
        got = np.load(os.path.join(pipe.cfg.dir("sem_seg"), name + ".npy"))
        want = np.load(os.path.join(jax_run["work"], "sem_seg", name + ".npy"))
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        out = {}
        TW.make_sem_seg_labels(model, pipe._nchw(TP.T.normalize_img(img.astype(np.float32))),
                               pipe._cam_dict(name), radius=3, beta=10.0, exp_times=2, out=out)
        s = np.sort(out["scores"].numpy(), axis=0)
        near = (s[-1] - s[-2]) < NEAR
        assert not ((got != want) & ~near).any(), name
        seen |= set(np.unique(want).tolist())
    assert len(seen) > 1
    got = pipe.run(["eval_sem_seg"])["eval_sem_seg"]
    assert 0.0 <= got <= 1.0
    _copy_dir(jax_run, pipe, "sem_seg")
    assert abs(pipe.eval_sem_seg() - jax_run["eval_sem_seg"]) <= MIOU_TOL


@pytest.mark.parametrize("h", [1, 2, 3, 5, 12, 47, 48, 50, 63, 130, 511, 513])
def test_nearest_reduction_equals_pillow(h):
    from PIL import Image

    rng = np.random.default_rng(h)
    for w in (1, 4, 7, 49, 128, 257):
        lab = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for oh, ow in {(max(h // 4, 1), max(w // 4, 1)), ((h + 3) // 4, (w + 3) // 4),
                       (int(rng.integers(1, 3 * h + 1)), int(rng.integers(1, 3 * w + 1)))}:
            want = np.asarray(Image.fromarray(lab).resize((ow, oh), Image.NEAREST))
            np.testing.assert_array_equal(TP.resize_nearest_pil(lab, (oh, ow)), want)


def test_full_pipeline_coco_source(tmp_path):
    """The COCO source branch (`run_wavecam_coco.py`'s): a COCO-14-shaped tree
    (JPEGImages/train2014, masks, a name list) drives every stage through the
    port's `CocoSource`."""
    from PIL import Image

    from representationlearning_tpu_torch.data.coco import CocoSource

    root = tmp_path / "coco14"
    (root / "JPEGImages" / "train2014").mkdir(parents=True)
    (root / "SegmentationClass" / "train2014").mkdir(parents=True)
    lists = tmp_path / "lists"
    lists.mkdir()
    rng = np.random.default_rng(3)
    n_classes = 4
    names = [f"COCO_train2014_{i:012d}" for i in range(4)]
    with open(lists / "train.txt", "w") as f:
        for name in names:
            img = rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)
            mask = np.zeros((48, 48), np.uint8)
            mask[10:30, 10:30] = int(rng.integers(1, n_classes + 1))
            Image.fromarray(img).save(root / "JPEGImages" / "train2014" / f"{name}.jpg")
            Image.fromarray(mask).save(root / "SegmentationClass" / "train2014" / f"{name}.png")
            f.write(name + "\n")
    pipe = port(tmp_path / "work", n_classes=n_classes, cam_scales=(1.0,), cam_batch_size=2,
                irn_batch_size=2, crf_method="native", coco_root=str(root),
                name_list_dir=str(lists), split="train_aug")
    assert isinstance(pipe.source, CocoSource) and len(pipe.source) == len(names)
    results = pipe.run(["train_cam", "train_wavecam", "make_cam", "eval_cam", "cam_to_ir_label",
                        "train_irn", "make_sem_seg", "eval_sem_seg"])
    assert 0.0 <= results["eval_cam"] <= 1.0 and 0.0 <= results["eval_sem_seg"] <= 1.0
    for sub in ("cam", "ir_label", "sem_seg"):
        assert sorted(os.listdir(pipe.cfg.dir(sub))) == sorted(n + ".npy" for n in names)
