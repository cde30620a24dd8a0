"""WaveCAM's multi-stage WSSS pipeline, the port of
``representationlearning_tpu/wsss/wavecam_pipeline.py`` (parity with
`WaveCAM-TMM2023/run_wavecam_voc.py`: the boolean pass gates `:82-92`, the stage
order `:114-167`). The stages hand their state on through files, as the JAX
package's do, so every stage can be resumed:

- ``weights/cam.npy`` (``Net``), ``weights/wavecam.npy`` (``{"net", "pred"}``)
  and ``weights/irn.npy`` (``IRNNet``): numpy dicts of the port's state-dict names
  (``convert/from_jax.py`` turns the JAX package's files into these);
- ``cam/<name>.npy``: the CAM dicts ``{"keys", "cam", "high_res"}`` (pickled);
- ``ir_label/<name>.npy`` and ``sem_seg/<name>.npy``: uint8 labels.

Stages: train_cam -> train_wavecam -> make_cam / make_wavecam -> eval_cam ->
cam_to_ir_label -> train_irn -> make_sem_seg_labels -> eval_sem_seg. The
per-image bodies of the inference stages are ``wsss/wavecam_infer.py``'s.

Samples are numpy in the JAX layout (H, W, 3), drawn with the JAX package's
seeds, and become NCHW tensors on the pipeline's device. Everything runs in f32
on one device: the card unless ``device`` says otherwise.

Known differences from the reference that the JAX package shares: one SGD over
the ``Net`` and the predictor at ``wavecam_lr`` (the reference gives the
backbone 0.1x, `train_wavecam.py:72-75`), and the CAMs are not detached from
the ``Net`` in ``train_wavecam``. IRN's backbone is frozen; its parameters get
zero gradients so that the weight decay and the momentum move them, as
optax's chain does to the JAX package's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.logging import AverageMeter, setup_logger
from ..data import transforms as T
from ..data.voc import SyntheticSegSource, VOC12Source, cls_onehot_from_mask
from ..losses.wsss import multilabel_soft_margin_loss
from ..metrics.seg import _fast_hist, scores_from_hist
from ..models.irn import AffinityDisplacementHead, IRNNet, irn_total_loss
from ..models.resnet import Net
from ..models.wavecam import ClassPredictorWavecam
from ..train.optim import make_sgd, poly_schedule
from . import msf, wavecam_infer
from .indexing import GetAffinityLabelFromIndices, PathIndex


@dataclass
class WaveCAMConfig:
    work_dir: str = "work_wavecam"
    n_classes: int = 20  # foreground classes
    crop_size: int = 512
    cam_scales: tuple = (1.0, 0.5, 1.5, 2.0)
    cam_batch_size: int = 16
    cam_epochs: int = 5
    cam_lr: float = 0.1
    cam_wd: float = 1e-4
    wavecam_lr: float = 0.01
    wavecam_epochs: int = 5
    wavecam_loss_weight: float = 1.0
    cam_eval_thres: float = 0.21
    conf_fg_thres: float = 0.35
    conf_bg_thres: float = 0.1
    irn_crop_size: int = 512
    irn_batch_size: int = 32
    irn_epochs: int = 3
    irn_lr: float = 0.1
    irn_wd: float = 1e-4
    beta: float = 10.0
    exp_times: int = 8
    sem_seg_bg_thres: float = 0.28
    rw_radius: int = 5
    irn_radius: float = 10.0
    # the CRF stages' bilateral filter: "grid" (the bilateral grid) or "native"
    # (the permutohedral lattice of `native/`, pydensecrf's own backend family)
    crf_method: str = "grid"
    seed: int = 0
    # the synthetic source's size, used when no VOC or COCO root is given
    synthetic_n: int = 16
    synthetic_size: tuple = (64, 64)
    voc12_root: str | None = None
    coco_root: str | None = None  # run_wavecam_coco.py's source: COCO-14
    name_list_dir: str | None = None
    split: str = "train_aug"

    def dir(self, sub):
        p = os.path.join(self.work_dir, sub)
        os.makedirs(p, exist_ok=True)
        return p


def resize_nearest_pil(label: np.ndarray, size) -> np.ndarray:
    """``PIL.Image.resize((w, h), NEAREST)`` of a (H, W) array: output pixel i
    reads source pixel int((i + 0.5) * in / out), the coordinate summed step by
    step in double precision, as Pillow's affine walk does."""
    def index(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        out = np.empty(n_out, np.int64)
        pos = 0.5 * step
        for i in range(n_out):
            out[i] = min(int(pos), n_in - 1)
            pos += step
        return out

    return label[index(label.shape[0], size[0])][:, index(label.shape[1], size[1])]


def _state_numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def _load_state(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                           strict=True)
    return module


def sgd_update(tx, loss: torch.Tensor) -> None:
    """One SGD update from ``loss``: its gradients (a zero gradient for every
    parameter that gets none, so that the weight decay and the momentum still move
    it), the step at the schedule's rate, the schedule moved on. The gradients stay
    in ``.grad`` until the next update."""
    tx.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in tx.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tx.optimizer.step()
    tx.scheduler.step()


def cam_step(net: Net, tx, img: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """One ``train_cam`` step: the multilabel soft-margin loss of the ``Net``'s
    logits. Returns the loss."""
    loss = multilabel_soft_margin_loss(net(img), label)
    sgd_update(tx, loss)
    return loss.detach()


def wavecam_step(net: Net, pred: ClassPredictorWavecam, tx, img: torch.Tensor,
                 label: torch.Tensor, loss_weight: float = 1.0):
    """One ``train_wavecam`` step: the ``Net``'s classification loss plus the
    predictor's (in its mode: training, as the stage runs it) on ``Net.cam_feature``.
    Returns (loss, accuracy)."""
    logits, cf, cams = net.cam_feature(img)
    loss_ce, acc = pred(cf, label, cams)
    loss = multilabel_soft_margin_loss(logits, label) + loss_weight * loss_ce
    sgd_update(tx, loss)
    return loss.detach(), acc


def irn_step(model: IRNNet, head: AffinityDisplacementHead, tx, img: torch.Tensor,
             bg_pos: torch.Tensor, fg_pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """One ``train_irn`` step on ``irn_total_loss``. Returns the loss."""
    edge, dp = model(img)
    loss, _ = irn_total_loss(head, edge, dp, bg_pos, fg_pos, neg)
    sgd_update(tx, loss)
    return loss.detach()


class WaveCAMPipeline:
    def __init__(self, cfg: WaveCAMConfig, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log = setup_logger("wavecam")
        if cfg.coco_root and os.path.isdir(os.path.join(cfg.coco_root, "JPEGImages")):
            from ..data.coco import CocoSource

            self.source = CocoSource(cfg.coco_root, cfg.name_list_dir,
                                     cfg.split.replace("_aug", ""))
        elif cfg.voc12_root and os.path.isdir(os.path.join(cfg.voc12_root, "JPEGImages")):
            self.source = VOC12Source(cfg.voc12_root, cfg.name_list_dir, cfg.split)
        else:
            self.source = SyntheticSegSource(
                n=cfg.synthetic_n, size=cfg.synthetic_size, num_classes=cfg.n_classes + 1
            )

    # ------------------------------------------------------------------ data helpers
    def _cls_samples(self, crop: int, aug: bool = True):
        """(name, normalised image crop, class one-hot) samples (the reference's
        ``VOC12ClassificationDataset``: flip and random crop)."""
        for idx in range(len(self.source)):
            name, img, mask = self.source.get(idx)
            onehot = cls_onehot_from_mask(mask, self.cfg.n_classes + 1)
            rng = np.random.default_rng((self.cfg.seed << 16) ^ idx)
            im = img.astype(np.float32)
            if aug:
                im = T.random_fliplr(rng, im)
                im, _ = T.random_crop(rng, im, None, crop_size=crop, mean_rgb=(0, 0, 0))
            im = T.normalize_img(im)
            yield name, im, onehot.astype(np.float32)

    def _batches(self, crop: int, batch_size: int, epochs: int):
        """(names, images (B, H, W, 3), labels (B, n_classes)) numpy batches, a new
        order each epoch, the last incomplete batch dropped."""
        samples = list(self._cls_samples(crop))
        rng = np.random.default_rng(self.cfg.seed)
        for _ in range(epochs):
            order = rng.permutation(len(samples))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                chunk = [samples[j] for j in order[i : i + batch_size]]
                yield (
                    [c[0] for c in chunk],
                    np.stack([c[1] for c in chunk]),
                    np.stack([c[2] for c in chunk]),
                )

    def _nchw(self, images: np.ndarray) -> torch.Tensor:
        """(..., H, W, 3) numpy -> (..., 3, H, W) on the device."""
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device) \
            .movedim(-1, -3).contiguous()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator().manual_seed(self.cfg.seed + offset)

    def _sgd(self, named_params, lr: float, wd: float, batch: int, epochs: int):
        max_step = max(len(self.source) // batch, 1) * epochs
        return make_sgd(named_params, lr, wd, schedule=poly_schedule(lr, max_step))

    def tensors(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        """A numpy batch on the device: images (B, H, W, 3) first, made NCHW."""
        return (self._nchw(arrays[0]),) + tuple(self._tensor(a) for a in arrays[1:])

    # ------------------------------------------------------------------- stage 1: cam
    def build_cam(self):
        """(Net, its SGD) as ``train_cam`` starts them."""
        cfg = self.cfg
        net = Net(stride=16, n_classes=cfg.n_classes, generator=self._generator(0),
                  device=self.device)
        return net, self._sgd(net, cfg.cam_lr, cfg.cam_wd, cfg.cam_batch_size, cfg.cam_epochs)

    def train_cam(self) -> Net:
        cfg = self.cfg
        net, tx = self.build_cam()
        meter = AverageMeter()
        for _, img, label in self._batches(cfg.crop_size, cfg.cam_batch_size, cfg.cam_epochs):
            meter.add(loss=float(cam_step(net, tx, *self.tensors(img, label))))
        self.log.info("train_cam done: loss=%.4f", meter.get("loss"))
        np.save(os.path.join(cfg.dir("weights"), "cam.npy"), _state_numpy(net),
                allow_pickle=True)
        return net

    def _load(self, name):
        return np.load(os.path.join(self.cfg.dir("weights"), name), allow_pickle=True).item()

    # -------------------------------------------------------------- stage 2: wavecam
    def build_wavecam(self):
        """(Net from ``cam.npy``, the predictor in training mode, one SGD over both)
        as ``train_wavecam`` starts them."""
        cfg = self.cfg
        net = _load_state(Net(stride=16, n_classes=cfg.n_classes, device=self.device),
                          self._load("cam.npy"))
        # representation_size is the backbone's feature width; the predictor maps
        # the wave output onto it through the canonical 32 x 32 grid
        pred = ClassPredictorWavecam(cfg.n_classes, representation_size=2048,
                                     generator=self._generator(1), device=self.device).train()
        named = ([("net." + n, p) for n, p in net.named_parameters()]
                 + [("pred." + n, p) for n, p in pred.named_parameters()])
        return net, pred, self._sgd(named, cfg.wavecam_lr, cfg.cam_wd, cfg.cam_batch_size,
                                    cfg.wavecam_epochs)

    def train_wavecam(self):
        cfg = self.cfg
        net, pred, tx = self.build_wavecam()
        meter = AverageMeter()
        for _, img, label in self._batches(cfg.crop_size, cfg.cam_batch_size,
                                           cfg.wavecam_epochs):
            loss, acc = wavecam_step(net, pred, tx, *self.tensors(img, label),
                                     loss_weight=cfg.wavecam_loss_weight)
            meter.add(loss=float(loss), acc=float(acc))
        self.log.info("train_wavecam done: loss=%.4f acc=%.4f", meter.get("loss"),
                      meter.get("acc"))
        np.save(os.path.join(cfg.dir("weights"), "wavecam.npy"),
                {"net": _state_numpy(net), "pred": _state_numpy(pred)}, allow_pickle=True)

    # ------------------------------------------------------------ stage 3: make cams
    def make_cam(self, use_wave_weight: bool = False):
        cfg = self.cfg
        net = Net(stride=16, n_classes=cfg.n_classes, device=self.device).eval()
        reweight = None
        if use_wave_weight:
            w = self._load("wavecam.npy")
            _load_state(net, w["net"])
            # forward2: the classifier's weight times the predictor's, elementwise
            # (`make_wavecam.py:38`, `resnet50_cam.py:136-147`)
            reweight = self._tensor(w["pred"]["classifier"])[:, :, None, None]
        else:
            _load_state(net, self._load("cam.npy"))
        out_dir = cfg.dir("cam")
        for idx in range(len(self.source)):
            name, img, mask = self.source.get(idx)
            onehot = cls_onehot_from_mask(mask, cfg.n_classes + 1)
            im = self._nchw(T.normalize_img(img.astype(np.float32)))
            d = wavecam_infer.make_cam(net, im, onehot, cfg.cam_scales, reweight=reweight)
            np.save(os.path.join(out_dir, name + ".npy"), d, allow_pickle=True)
        self.log.info("make_cam done (%d images)", len(self.source))

    def _cam_dict(self, name: str) -> dict:
        return np.load(os.path.join(self.cfg.dir("cam"), name + ".npy"), allow_pickle=True).item()

    def _miou(self, stage: str, label_fn) -> float:
        """The mIoU over the source of the labels ``label_fn(name)`` gives."""
        n = self.cfg.n_classes + 1
        hist = np.zeros((n, n))
        for idx in range(len(self.source)):
            name, _, mask = self.source.get(idx)
            hist += _fast_hist(mask.flatten(), label_fn(name).flatten(), n)
        miou = scores_from_hist(hist)["miou"]
        self.log.info("%s miou=%.4f", stage, miou)
        return miou

    # -------------------------------------------------------------- stage 4: eval cam
    def eval_cam(self) -> float:
        return self._miou("eval_cam", lambda name: msf.cam_dict_to_label(
            self._cam_dict(name), self.cfg.cam_eval_thres))

    # ----------------------------------------------------- stage 5: cam_to_ir_label
    def cam_to_ir_label(self):
        cfg = self.cfg
        out_dir = cfg.dir("ir_label")
        for idx in range(len(self.source)):
            name, img, _ = self.source.get(idx)
            conf = wavecam_infer.cam_to_ir_label(
                self._nchw(img.astype(np.float32)), self._cam_dict(name), cfg.conf_fg_thres,
                cfg.conf_bg_thres, cfg.crf_method)
            np.save(os.path.join(out_dir, name + ".npy"), conf.cpu().numpy())
        self.log.info("cam_to_ir_label done")

    # ----------------------------------------------------------- stage 6: train irn
    def irn_samples(self, feat: int, aff_labeler) -> list:
        """(normalised crop, bg_pos, fg_pos, neg) numpy samples from the IR labels:
        a random crop, the label reduced x0.25 by Pillow's nearest rule
        (`dataloader.py:391`), its affinity labels."""
        cfg = self.cfg
        samples = []
        for idx in range(len(self.source)):
            name, img, _ = self.source.get(idx)
            lab = np.load(os.path.join(cfg.dir("ir_label"), name + ".npy"))
            rng = np.random.default_rng((cfg.seed << 12) ^ idx)
            im, lab2, _ = T.random_crop(
                rng, img.astype(np.float32), lab, crop_size=cfg.irn_crop_size,
                mean_rgb=(0, 0, 0), ignore_index=255,
            )
            reduced = resize_nearest_pil(lab2.astype(np.uint8), (feat, feat))
            samples.append((T.normalize_img(im), *aff_labeler(reduced)))
        return samples

    def build_irn(self):
        """(IRNNet, its loss head, the affinity labeler, its SGD) as ``train_irn``
        starts them."""
        cfg = self.cfg
        feat = cfg.irn_crop_size // 4
        path_index = PathIndex(radius=cfg.irn_radius, default_size=(feat, feat))
        head = AffinityDisplacementHead(path_index)
        aff_labeler = GetAffinityLabelFromIndices(path_index.src_indices, path_index.dst_indices)
        model = IRNNet(generator=self._generator(2), device=self.device)
        tx = self._sgd(model, cfg.irn_lr, cfg.irn_wd, cfg.irn_batch_size, cfg.irn_epochs)
        return model, head, aff_labeler, tx

    def irn_batch(self, samples: list) -> tuple[torch.Tensor, ...]:
        """(images NCHW, bg_pos, fg_pos, neg) of ``irn_samples``' samples."""
        return self.tensors(*(np.stack([s[k] for s in samples]) for k in range(4)))

    def train_irn(self):
        cfg = self.cfg
        model, head, aff_labeler, tx = self.build_irn()
        samples = self.irn_samples(cfg.irn_crop_size // 4, aff_labeler)
        meter = AverageMeter()
        bs = cfg.irn_batch_size
        for _ in range(cfg.irn_epochs):
            for i in range(0, len(samples) - bs + 1, bs):
                loss = irn_step(model, head, tx, *self.irn_batch(samples[i : i + bs]))
                meter.add(loss=float(loss))
        self.log.info("train_irn done: loss=%.4f", meter.get("loss"))

        # MeanShift calibration (`train_irn.py:95-110`): the mean displacement over
        # the first half of the samples, one image at a time
        dp_means = []
        with torch.no_grad():
            for im, *_ in samples[: max(1, len(samples) // 2)]:
                _, dp = model(self._nchw(im[None]))
                dp_means.append(dp.cpu().numpy().mean(axis=(0, 2, 3)))
        model.mean_shift.running_mean.copy_(self._tensor(np.mean(dp_means, axis=0)))
        np.save(os.path.join(cfg.dir("weights"), "irn.npy"), _state_numpy(model),
                allow_pickle=True)

    # ------------------------------------------------- stage 7: make_sem_seg_labels
    def make_sem_seg_labels(self):
        cfg = self.cfg
        model = _load_state(IRNNet(device=self.device), self._load("irn.npy")).eval()
        out_dir = cfg.dir("sem_seg")
        for idx in range(len(self.source)):
            name, img, _ = self.source.get(idx)
            pred = wavecam_infer.make_sem_seg_labels(
                model, self._nchw(T.normalize_img(img.astype(np.float32))), self._cam_dict(name),
                radius=cfg.rw_radius, beta=cfg.beta, exp_times=cfg.exp_times,
                bg_thres=cfg.sem_seg_bg_thres)
            np.save(os.path.join(out_dir, name + ".npy"), pred.cpu().numpy().astype(np.uint8))
        self.log.info("make_sem_seg_labels done")

    # ----------------------------------------------------- stage 8: eval sem seg
    def eval_sem_seg(self) -> float:
        return self._miou("eval_sem_seg", lambda name: np.load(
            os.path.join(self.cfg.dir("sem_seg"), name + ".npy")))

    # --------------------------------------------------------------------- pipeline
    def run(self, passes: Sequence[str]):
        """The gated stages in the order given (`run_wavecam_voc.py:114-167`):
        {stage: its result}."""
        stage_map = {
            "train_cam": self.train_cam,
            "train_wavecam": self.train_wavecam,
            "make_cam": self.make_cam,
            "make_wavecam": lambda: self.make_cam(use_wave_weight=True),
            "eval_cam": self.eval_cam,
            "cam_to_ir_label": self.cam_to_ir_label,
            "train_irn": self.train_irn,
            "make_sem_seg": self.make_sem_seg_labels,
            "eval_sem_seg": self.eval_sem_seg,
        }
        results = {}
        for p in passes:
            self.log.info("=== stage %s ===", p)
            results[p] = stage_map[p]()
        return results
