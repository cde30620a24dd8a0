"""Multi-scale flip CAMs of the PyTorch port (`wsss/msf.py`) against the JAX
package, and the WaveCAM pseudo-label slice end to end (`wsss/wavecam_infer.py`):

- `msf_cam_single` with the same small fixed conv as `cam_fn` on both sides, which
  holds the MSF arithmetic (scaled sizes rounded half to even, flip sums, strided
  and high-resolution resizes) without ResNet, within 1e-5 of the largest;
- `finalize_cam_dict`, `cam_dict_to_label` and `evaluate_cam_multi_thres`, exact;
- one image at 64 x 96, scales (1.0, 0.5): `make_cam` -> `cam_to_ir_label` ->
  `make_sem_seg_labels`, each package's functions composed as
  `wsss/wavecam_pipeline.py` composes them, the port on JAX's weights (jittered
  `Net` and `IRNNet` variables through `convert/from_jax.py`); the CAM dicts within
  2e-4 of the largest, the labels equal except where JAX's two best scores are
  within 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import irn as JI
from representationlearning_tpu.models import resnet as JR
from representationlearning_tpu.ops import crf as JC
from representationlearning_tpu.ops.image import resize_bilinear_auto
from representationlearning_tpu.wsss import indexing as JX
from representationlearning_tpu.wsss import msf as JM
from representationlearning_tpu_torch.convert.from_jax import (irn_state_dict_from_jax,
                                                               wavecam_net_state_dict_from_jax)
from representationlearning_tpu_torch.models.irn import IRNNet
from representationlearning_tpu_torch.models.resnet import Net
from representationlearning_tpu_torch.wsss import msf as TM
from representationlearning_tpu_torch.wsss import wavecam_infer as TW

torch.set_num_threads(2)

MSF_TOL = 1e-5   # a 3 x 3 conv and bilinear resizes in f32, relative to the largest
REL = 2e-4       # f32 through ResNet-50, relative to the largest
NEAR = 1e-3      # a label may differ only where JAX's two best scores are this close
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _chw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, -3)))


def _conv_pair(seed, C=5):
    """The same 3 x 3 conv, stride 4, for both packages' `cam_fn`."""
    w = np.random.default_rng(seed).standard_normal((3, 3, 3, C)).astype(np.float32)

    def jax_fn(pair):   # (2, h, w, 3) -> (2, h', w', C)
        return jax.lax.conv_general_dilated(pair, jnp.asarray(w), (4, 4), ((1, 1), (1, 1)),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    wt = torch.from_numpy(np.array(w.transpose(3, 2, 0, 1)))

    def torch_fn(pair):   # (2, 3, h, w) -> (2, C, h', w')
        return torch.nn.functional.conv2d(pair, wt, stride=4, padding=1)

    return jax_fn, torch_fn


@pytest.mark.parametrize("H,W,scales", [(45, 70, (1.0, 0.5, 1.5, 2.0)), (33, 50, (0.7, 1.3))])
def test_msf_cam_single_matches_jax(H, W, scales):
    """45 x 0.5 = 22.5 rounds to 22 and 33 x 1.3 = 42.9 to 43 on both sides."""
    image = np.random.default_rng(1).standard_normal((H, W, 3)).astype(np.float32)
    jfn, tfn = _conv_pair(2)
    ws, wh = JM.msf_cam_single(jfn, jnp.asarray(image), scales)
    gs, gh = TM.msf_cam_single(tfn, _chw(image), scales)
    assert gs.shape == (5,) + TM.get_strided_size((H, W), 4) and gh.shape == (5, H, W)
    for got, want in ((gs, ws), (gh, wh)):
        want = np.moveaxis(np.asarray(want), -1, 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=MSF_TOL * np.abs(want).max())


def test_sizes_match_jax():
    for size in ((375, 500), (64, 96), (1, 1), (17, 33)):
        for stride in (4, 16):
            assert TM.get_strided_size(size, stride) == JM.get_strided_size(size, stride)
            assert TM.get_strided_up_size(size, stride) == JM.get_strided_up_size(size, stride)


def _cam_dicts(seed, n=3, C=20, H=24, W=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        strided = rng.random((H // 4, W // 4, C)).astype(np.float32)
        high = rng.random((H, W, C)).astype(np.float32) ** 3
        onehot = np.zeros(C, np.uint8)
        onehot[rng.choice(C, rng.integers(1, 4), replace=False)] = 1
        out.append((strided, high, onehot))
    return out


def test_finalize_and_labels_equal_jax():
    gts = []
    t_dicts, j_dicts = [], []
    rng = np.random.default_rng(4)
    for strided, high, onehot in _cam_dicts(3):
        want = JM.finalize_cam_dict(strided, high, onehot)
        got = TM.finalize_cam_dict(torch.from_numpy(np.moveaxis(strided, -1, 0).copy()),
                                   torch.from_numpy(np.moveaxis(high, -1, 0).copy()),
                                   torch.from_numpy(onehot))
        assert set(got) == {"keys", "cam", "high_res"}
        for k in got:
            assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for thres in (0.05, 0.21, 0.5):
            np.testing.assert_array_equal(TM.cam_dict_to_label(got, thres),
                                          JM.cam_dict_to_label(want, thres))
        t_dicts.append(got)
        j_dicts.append(want)
        gts.append(np.where(rng.random(high.shape[:2]) < 0.1, 255,
                            JM.cam_dict_to_label(want, 0.3)))
    want = JM.evaluate_cam_multi_thres(j_dicts, gts, 21)
    got = TM.evaluate_cam_multi_thres(t_dicts, gts, 21)
    assert got == want and len(got["per_threshold"]) == 10


# ------------------------------------------------------------------ end to end
H, W, SCALES = 64, 96, (1.0, 0.5)


def _jitter(variables, seed):
    """BatchNorm scales halved and noise on every statistic, scale and bias (as
    tests/test_torch_irn.py does)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "var":
            return (rng.random(a.shape) * 0.5 + 0.75).astype(np.float32)
        if name == "scale":
            factor = 0.5 if path[-2].key.startswith(("bn", "downsample_bn")) else 1.0
            return (a * factor + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bias", "mean", "dp_running_mean"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _image(seed):
    """A VOC-like image in [0, 255] (H, W, 3): smooth colour fields, two discs."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((4, 6, 3)).astype(np.float32)
    img = np.asarray(resize_bilinear_auto(jnp.asarray(coarse)[None], (H, W)))[0] * 160 + 40
    yy, xx = np.mgrid[0:H, 0:W]
    for cy, cx, r in ((20, 30, 12), (44, 70, 15)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.random(3) * 255
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.float32)


def _crf_label(img, labels, n_labels):
    """JAX's `crf_inference_label` (the argmax of its mean-field call, made here
    with the same arguments) and where its two best Q are within NEAR."""
    u = JC.unary_from_labels(jnp.asarray(labels), n_labels, 0.7)
    q = np.asarray(JC.mean_field_inference(jnp.asarray(img, jnp.float32), u, t=10, sxy_g=3.0,
                                           compat_g=3.0, sxy_b=50.0, srgb_b=5.0,
                                           compat_b=10.0, method="grid"))
    s = np.sort(q, axis=-1)
    return q.argmax(-1), (s[..., -1] - s[..., -2]) < NEAR


def _top2_near(scores, axis=0):
    s = np.sort(scores, axis=axis)
    return (np.take(s, -1, axis) - np.take(s, -2, axis)) < NEAR


@pytest.fixture(scope="module")
def chain():
    """JAX's stages as `wsss/wavecam_pipeline.py` runs them, for one image."""
    img = _image(0)
    im = (img - MEAN) / STD
    onehot = np.zeros(20, np.uint8)
    onehot[[3, 14]] = 1
    net, irn = JR.Net(stride=16, n_classes=20), JI.IRNNet()
    nv = _jitter(net.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3))), 1)
    iv = _jitter(irn.init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3))), 2)
    # a random classifier's CAMs are negative everywhere (the features are ReLU'd);
    # each present class's weight becomes the centred feature of a pixel in one disc,
    # so that its CAM is high where the image looks like that disc
    f = np.asarray(net.apply(nv, jnp.asarray(im)[None], method=JR.Net.features))[0]
    m = f.mean(axis=(0, 1))
    f = f - m
    kernel = np.array(nv["params"]["classifier"]["kernel"])
    for c, (y, x) in ((3, (20, 30)), (14, (44, 70))):
        w = f[y // 16, x // 16]
        w = w - (w @ m) / (m @ m) * m   # orthogonal to the mean feature: CAMs centred at 0
        kernel[0, 0, :, c] = w / np.linalg.norm(w)
    nv["params"]["classifier"]["kernel"] = jnp.asarray(kernel)
    # make_cam (`:221-247`)
    cam_kernel = nv["params"]["classifier"]["kernel"]
    strided, high = JM.msf_cam_single(
        lambda pair: net.apply(nv, pair, cam_kernel, method=JR.Net.cam), jnp.asarray(im), SCALES)
    d = JM.finalize_cam_dict(strided, high, onehot)
    # cam_to_ir_label (`:263-286`)
    keys = np.pad(d["keys"] + 1, (1, 0), mode="constant")
    confs, near_ir = [], np.zeros((H, W), bool)
    for thres in (0.35, 0.1):
        padded = np.pad(d["high_res"], ((1, 0), (0, 0), (0, 0)), constant_values=thres)
        pred, near = _crf_label(img, np.argmax(padded, 0), max(len(keys), 2))
        confs.append(keys[pred])
        near_ir |= _top2_near(padded) | near
    fg_conf, bg_conf = confs
    conf = fg_conf.copy()
    conf[fg_conf == 0] = 255
    conf[bg_conf + fg_conf == 0] = 0
    # make_sem_seg_labels (`:364-391`)
    pair = np.stack([im, im[:, ::-1]])
    edge, _ = JI.edge_displacement_infer(
        lambda v, x, **kw: irn.apply(v, x, apply_mean_shift=True), iv, jnp.asarray(pair))
    cams = jnp.asarray(d["cam"])
    rw = JX.propagate_to_edge(cams, edge[:cams.shape[1], :cams.shape[2]], 5, 10.0, 8)
    rw_up = resize_bilinear_auto(rw.transpose(1, 2, 0)[None],
                                 (cams.shape[1] * 4, cams.shape[2] * 4))[0][:H, :W]
    rw_up = rw_up / (rw_up.max() + 1e-12)
    scores = np.asarray(jnp.concatenate([jnp.full((H, W, 1), 0.28), rw_up], axis=-1))
    sem = keys[np.argmax(scores, -1)].astype(np.uint8)
    return dict(img=img, im=im, onehot=onehot, nv=nv, iv=iv, dict=d, conf=conf.astype(np.uint8),
                near_ir=near_ir, sem=sem, near_sem=_top2_near(scores, -1))


def test_pseudo_label_chain_matches_jax(chain):
    net = Net(16, 20, device="cpu").eval()
    net.load_state_dict(wavecam_net_state_dict_from_jax(chain["nv"]), strict=True)
    irn = IRNNet(device="cpu").eval()
    irn.load_state_dict(irn_state_dict_from_jax(chain["iv"]), strict=True)
    im, img = _chw(chain["im"]), _chw(chain["img"])

    d = TW.make_cam(net, im, torch.from_numpy(chain["onehot"]), SCALES)
    want = chain["dict"]
    np.testing.assert_array_equal(d["keys"], want["keys"])
    assert d["cam"].shape == (2, H // 4, W // 4) and d["high_res"].shape == (2, H, W)
    for k in ("cam", "high_res"):
        np.testing.assert_allclose(d[k], want[k], rtol=0, atol=REL)   # max-normalised

    conf = TW.cam_to_ir_label(img, d)
    assert conf.dtype == torch.uint8 and conf.shape == (H, W)
    assert set(np.unique(chain["conf"])) >= {0, 255}
    assert not ((conf.numpy() != chain["conf"]) & ~chain["near_ir"]).any()

    out = {}
    sem = TW.make_sem_seg_labels(irn, im, d, out=out)
    assert sem.shape == (H, W) and out["trans"].shape == ((H // 4) * (W // 4),) * 2
    assert (out["trans"].sum(0) - 1).abs().max() < 1e-3
    assert set(np.unique(sem.numpy())) <= {0, 4, 15}
    assert not ((sem.numpy() != chain["sem"]) & ~chain["near_sem"]).any()
    assert chain["near_sem"].mean() < 0.01 and chain["near_ir"].mean() < 0.05
