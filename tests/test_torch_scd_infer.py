"""The slice as a whole: `scd_pseudo_labels` and `make_scd_eval_step` of the port
against the lines of the JAX trainer they port (`train/scd.py:96,111-129` and
`:196-227`), on the smallest MiT (`mit_b0`) at 64 x 64, f32, batch 2, with the
JAX weights carried over by `tscd_state_dict_from_jax`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.refine import varm_refine as j_varm_refine
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu.ops import image as JI
from representationlearning_tpu.train import scd as JS
from representationlearning_tpu.wsss import camutils as JCU
from representationlearning_tpu_torch.convert.from_jax import tscd_state_dict_from_jax
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.ops import affinity as TA
from representationlearning_tpu_torch.ops import mit_block as tmb
from representationlearning_tpu_torch.ops import varm as TV
from representationlearning_tpu_torch.train import scd as TS

torch.set_num_threads(2)

CAM_ATOL = 2e-4   # f32 end to end, the bound of tests/test_parity_torch_e2e.py:21
NEAR = 1e-3       # a label may differ only where the JAX side is this close to a tie
KW = dict(num_classes=21, crop_size=64, cam_scales=(1.0, 0.5, 1.5),
          varm_dilations=(1, 2, 4), varm_iters=4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    x[1, :, 52:] = 0.0  # a zero-padded crop: constant after denormalisation
    cls = np.zeros((2, 20), np.float32)
    cls[0, [3, 11]] = 1
    cls[1, [0, 7, 19]] = 1
    box = np.array([[0, 64, 0, 64], [0, 64, 0, 52]])
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=21).init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    sd = tscd_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v))
    return x, cls, box, v, sd


def _port(sd, **kw):
    m = TSCD("mit_b0", 21, fused_blocks=True, device="cpu", **kw).eval()
    m.load_state_dict(sd)
    return m


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _top2_close(scores, valid):
    """Where the two largest valid scores along the last axis are within NEAR."""
    top = np.sort(np.where(valid, scores, -np.inf), axis=-1)
    return (top[..., -1] - top[..., -2]) < NEAR


def _check_labels(name, got, want, close):
    differ = got != want
    print(f"{name}: {int(differ.sum())} of {differ.size} differ, "
          f"{int(close.sum())} pixels at a near-tie")
    assert not (differ & ~close).any(), f"{name} differs away from a near-tie"
    return differ


@pytest.mark.parametrize("max_present", [None, 8])
def test_scd_pseudo_labels_match_jax(setup, max_present):
    x, cls, box, v, sd = setup
    cfg = JS.SCDConfig(max_present=max_present, **KW)
    twin = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True, collect_attns="none")
    inputs, cls_labels, img_box = jnp.asarray(x), jnp.asarray(cls), jnp.asarray(box)
    seen = {}

    def refine_fn(im, m):
        seen["both"] = j_varm_refine(im, m, dilations=cfg.varm_dilations,
                                     num_iter=cfg.varm_iters)
        return seen["both"]

    # train/scd.py:96 and :111-129, in order
    cam_fn = jax.jit(lambda a: twin.apply(v, a, cam_only=True))  # one program per scale
    cams, _ = JCU.multi_scale_cam_with_ref_mat(cam_fn, inputs, cfg.cam_scales)
    valid_cam, pseudo_label = JCU.cam_to_label(
        cams, cls_labels, img_box, ignore_mid=True, bkg_score=cfg.bkg_score,
        high_thre=cfg.high_thre, low_thre=cfg.low_thre, ignore_index=cfg.ignore_index)
    inputs_denorm = inputs * jnp.asarray(cfg.std) + jnp.asarray(cfg.mean)
    refined_label = JCU.refine_cams_with_bkg_v2(
        refine_fn, inputs_denorm, cams, cls_labels, img_box, high_thre=cfg.high_thre,
        low_thre=cfg.low_thre, ignore_index=cfg.ignore_index, max_present=cfg.max_present)
    ref_label = JCU.cams_to_refine_label(refined_label, mask=JS._attn_mask(cfg),
                                         ignore_index=cfg.ignore_index, down=16)

    t_cfg = TS.SCDConfig(max_present=max_present, **KW)
    for mod in (tmb, TA, TV):
        mod.reset_launches()
    got = TS.scd_pseudo_labels(_port(sd, collect_attns="none"), _nchw(x),
                               torch.from_numpy(cls), torch.from_numpy(box), t_cfg,
                               attn_mask=TS._attn_mask(t_cfg, "cpu"))
    t_cams, t_pseudo, t_refined, t_ref = got
    assert sum(tmb.LAUNCHES.values()) + TA.LAUNCHES["affinity"] \
        + TV.LAUNCHES["varm_propagate"] == 0  # CPU tensors: plain versions only
    assert t_cams.shape == (2, 20, 64, 64) and t_ref.shape == (2, 16, 16)
    np.testing.assert_allclose(t_cams.numpy().transpose(0, 2, 3, 1), np.asarray(cams),
                               atol=CAM_ATOL)

    # pseudo label: a pixel may move only near a threshold or a tie of two classes
    vc = np.asarray(valid_cam)
    value = vc.max(-1)
    near_thre = np.zeros(value.shape, bool)
    for t in (cfg.bkg_score, cfg.high_thre, cfg.low_thre):
        near_thre |= np.abs(value - t) < NEAR
    close = near_thre | (_top2_close(vc, True) & (value > cfg.low_thre))
    _check_labels("pseudo_label", t_pseudo.numpy(), np.asarray(pseudo_label), close)

    # refined label: only at a near-tie of the top two refined probabilities
    P = 20 if max_present is None else max_present
    both = np.asarray(JI.resize_bilinear(seen["both"], (64, 64)))
    cls_c = cls if max_present is None else np.take_along_axis(
        cls, np.argsort(1.0 - cls, axis=1, kind="stable")[:, :P], axis=1)
    valid = np.concatenate([np.ones((2, 1)), cls_c], 1)[:, None, None, :] > 0
    close = _top2_close(both[..., :P + 1], valid) | _top2_close(both[..., P + 1:], valid)
    differ = _check_labels("refined_label", t_refined.numpy(), np.asarray(refined_label), close)
    if not differ.any():
        np.testing.assert_array_equal(t_ref.numpy(), np.asarray(ref_label))
    labels = set(np.unique(t_refined.numpy()[0]))
    assert labels <= {0, 4, 12, 255} and (t_refined[1, :, 52:] == 255).all()


def test_scd_eval_step_matches_jax(setup):
    x, cls, box, v, sd = setup
    cfg = JS.SCDConfig(**KW)
    model = JTSCD(backbone="mit_b0", num_classes=21, fused_blocks=True)
    want = JS.make_scd_eval_step(model.apply, cfg)(
        v, {"image": jnp.asarray(x), "cls_label": jnp.asarray(cls)})
    step = TS.make_scd_eval_step(_port(sd), TS.SCDConfig(**KW), device="cpu")
    got = step({"image": _nchw(x), "cls_label": torch.from_numpy(cls)})
    assert set(got) == {"seg_pred", "cam_label", "ref_label", "cls_pred"}
    np.testing.assert_array_equal(got["cls_pred"].numpy(), np.asarray(want["cls_pred"]))
    for k in ("seg_pred", "cam_label", "ref_label"):
        assert got[k].shape == (2, 64, 64)
        differ = got[k].numpy() != np.asarray(want[k])
        print(f"{k}: {int(differ.sum())} of {differ.size} differ")
        # argmax of maps that agree to CAM_ATOL: a handful of pixels at ties at most
        assert differ.mean() <= 2e-3


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = TS.SCDConfig(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS._attn_mask(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.make_scd_eval_step(None, cfg)
    assert TS._attn_mask(cfg, "cpu").shape == (16, 16)
    assert TS._down_size(64) == 4 and TS._down_size(70) == 5
