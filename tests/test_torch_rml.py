"""The RML models of the port (`models/rml.py`) against the JAX package's, f32:
`RMLModel` with and without the wave block, `cam_only` and full, at `mit_b0` 64²
(JAX weights converted by `rml_state_dict_from_jax`); `ClassPredictor`; and every
point of the `WeTrAttnAff` grid by the round trip port seed -> state_dict ->
`convert_wetr_attn_aff` (strict) -> JAX apply, and back through
`wetr_attn_aff_state_dict_from_jax`."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert import torch2jax as C
from representationlearning_tpu.models.rml import ClassPredictor as JClassPredictor
from representationlearning_tpu.models.rml import RMLModel as JRMLModel
from representationlearning_tpu.models.rml import WeTrAttnAff as JWeTrAttnAff
from representationlearning_tpu_torch.convert.from_jax import (rml_state_dict_from_jax,
                                                               wetr_attn_aff_state_dict_from_jax)
from representationlearning_tpu_torch.models.rml import ClassPredictor, RMLModel, WeTrAttnAff

torch.set_num_threads(2)
TOL = 2e-4   # f32 end to end through eight blocks (tests/test_parity_torch_e2e.py:21)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, layout=None):
    want = np.asarray(want)
    if layout == "nhwc":
        want = want.transpose(0, 3, 1, 2)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _image(seed, side=64):
    return np.random.default_rng(seed).standard_normal((2, 3, side, side)).astype(np.float32)


def _jitter_jax(v, seed):
    """Noise on biases, scales and statistics, so that a fresh initialisation's
    zeros and ones hide no wiring."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return a * (0.5 + rng.random(a.shape).astype(np.float32))
        if path[-1].key in ("bias", "scale", "mean"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, v)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "wave"])
def rml_pair(request):
    use_wave = request.param
    x = _image(1)
    j = JRMLModel(backbone="mit_b0", num_classes=21, use_wave=use_wave)
    v = _jitter_jax(_np(jax.jit(j.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x.transpose(0, 2, 3, 1)))), 1)
    t = RMLModel("mit_b0", 21, use_wave=use_wave, device="cpu").eval()
    t.load_state_dict(rml_state_dict_from_jax(v))   # strict: every name maps
    return j, v, t, x


def test_rml_model_full_forward_matches_jax(rml_pair):
    j, v, t, x = rml_pair
    cls, seg, attns, pred = jax.jit(j.apply)(v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        t_cls, t_seg, t_attns, t_pred = t(torch.from_numpy(x))
    assert t_seg.shape == (2, 15, 16, 16) and t_pred.shape == (2, 16, 16)
    _close(t_cls, cls, "cls")
    _close(t_seg, seg, "seg", "nhwc")
    _close(t_pred, pred, "attn_pred")
    assert len(t_attns) == len(attns) == 2
    for a, b in zip(t_attns, attns):
        _close(a, b, "attns")


def test_rml_model_cam_only_matches_jax(rml_pair):
    j, v, t, x = rml_pair
    cam, pred = jax.jit(lambda v, x: j.apply(v, x, cam_only=True))(
        v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    xt = torch.from_numpy(x).requires_grad_()
    t_cam, t_pred = t(xt, cam_only=True)
    assert t_cam.shape == (2, 20, 4, 4) and not t_cam.requires_grad   # detached, as in JAX
    _close(t_cam, cam, "cam", "nhwc")
    _close(t_pred, pred, "attn_pred")


def test_rml_fused_twin_shares_the_model_and_matches_it():
    """The CAM twin of the train step (`fused_blocks=True, collect_attns="none"`) on
    the model's own parameters gives the model's CAM (plain K1 on the CPU)."""
    from representationlearning_tpu_torch.models.tscd import share_parameters

    gen = torch.Generator().manual_seed(4)
    m = RMLModel("mit_b0", 21, device="cpu", generator=gen).eval()
    twin = share_parameters(RMLModel("mit_b0", 21, fused_blocks=True, collect_attns="none",
                                     device="cpu"), m).eval()
    assert all(a is b for a, b in zip(twin.parameters(), m.parameters()))
    x = torch.from_numpy(_image(2))
    with torch.no_grad():
        cam, pred = twin(x, cam_only=True)
        want, _ = m(x, cam_only=True)
    assert pred is None
    torch.testing.assert_close(cam, want, rtol=TOL, atol=TOL * want.abs().max().item())


def test_rml_model_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RMLModel("mit_b0", 21)
    a, b = (RMLModel("mit_b0", 21, use_wave=True, device="cpu",
                     generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert {"neck.fuse_conv.0.weight", "neck.fuse_conv.1.running_var",
            "wave.reweight.fc2.weight", "attn_proj.weight", "classifier.weight"} <= \
        set(a.state_dict())


@pytest.mark.parametrize("present", ["mixed", "none"])
def test_class_predictor_matches_jax(present):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    label = (rng.random((3, 20)) < 0.3).astype(np.float32)
    if present == "none":
        label[1] = 0.0   # an image without classes: its loss is 0, it adds nothing
    j = JClassPredictor(num_classes=20, representation_size=32)
    v = _np(j.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(label)))
    loss, acc = j.apply(v, jnp.asarray(x), jnp.asarray(label))
    t = ClassPredictor(20, 32, device="cpu")
    with torch.no_grad():
        t.classifier.weight.copy_(torch.from_numpy(v["params"]["classifier_kernel"].T)[..., None,
                                                                                      None])
    t_loss, t_acc = t(torch.from_numpy(x), torch.from_numpy(label))
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=1e-5)
    assert float(t_acc) == pytest.approx(float(acc), abs=1e-7)


GRID = list(itertools.product(("attns", "x4_last", "x4_prev"), ("none", "stage4", "post_cls")))


@pytest.mark.parametrize("attn_source,wave_mode", GRID)
def test_wetr_attn_aff_round_trip_matches_jax(attn_source, wave_mode):
    gen = torch.Generator().manual_seed(7)
    t = WeTrAttnAff("mit_b0", 21, attn_source=attn_source, wave_mode=wave_mode,
                    device="cpu", generator=gen).eval()
    with torch.no_grad():   # biases and norms off their zeros and ones
        for name, p in itertools.chain(t.named_parameters(), t.named_buffers()):
            if name.endswith("running_var"):
                p.mul_(0.5 + torch.rand(p.shape, generator=gen))
            elif p.is_floating_point() and (name.endswith(("bias", "running_mean"))
                                            or "norm" in name or ".bn." in name):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    sd = C.state_dict_to_numpy(t.state_dict())
    v = C.convert_wetr_attn_aff(sd, attn_source=attn_source, wave_mode=wave_mode, strict=True)
    back = wetr_attn_aff_state_dict_from_jax(v)
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)   # bit for bit

    x = _image(8)
    j = JWeTrAttnAff(backbone="mit_b0", num_classes=21, attn_source=attn_source,
                     wave_mode=wave_mode)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    cls, seg, _, pred = jax.jit(j.apply)(v, xj)
    cam, _ = jax.jit(lambda v, x: j.apply(v, x, cam_only=True))(v, xj)
    with torch.no_grad():
        t_cls, t_seg, _, t_pred = t(torch.from_numpy(x))
        t_cam, _ = t(torch.from_numpy(x), cam_only=True)
    _close(t_cls, cls, "cls")
    _close(t_seg, seg, "seg", "nhwc")
    _close(t_pred, pred, "attn_pred")
    _close(t_cam, cam, "cam", "nhwc")
