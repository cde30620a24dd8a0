"""WaveCAM's wave-modeling block and predictor of the PyTorch port
(`models/wavecam.py`) against the JAX package, on JAX's variables carried across by
`convert/from_jax.py::wavecam_predictor_state_dict_from_jax` (strict loads):

- `WaveModeling` in eval and in training mode within 2e-5 of the largest output,
  the running statistics after a training forward within 1e-5;
- `ClassPredictorWavecam`'s (loss, acc) with several label masks, an empty one
  among them, at the canonical grid (the identity) and through the bilinear
  resize onto it (square and not);
- the gradients of the loss on the features, the CAMs and every parameter within
  2e-4 of each tensor's largest entry (in f64 in training mode, see below);
- the state-dict names, the converter's round trip and the device rule.

Every kernel, bias, BatchNorm scale and statistic is drawn anew with numpy, so
that no weight is symmetric (the grouped token FCs take their inputs in pairs)
and the BatchNorms' wiring shows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import wavecam as JW
from representationlearning_tpu_torch.convert.from_jax import (
    state_dict_from_jax, wavecam_predictor_state_dict_from_jax)
from representationlearning_tpu_torch.models import wavecam as TW

torch.set_num_threads(2)

TOL = 2e-5        # f32 forwards, of the largest magnitude
STATS_TOL = 1e-5  # running statistics after one training forward
GRAD_TOL = 2e-4   # gradients, of each tensor's largest entry
C = 5


def _redraw(variables, seed):
    """Every leaf drawn anew: kernels and biases normal, BatchNorm scales around
    1, means normal, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        shape = np.shape(a)
        if name == "var":
            return jnp.asarray(rng.random(shape) + 0.5, jnp.float32)
        if name == "scale":
            return jnp.asarray(1.0 + 0.2 * rng.standard_normal(shape), jnp.float32)
        scale = 0.3 if name in ("bias", "mean") else 1.0 / np.sqrt(max(np.prod(shape[:-1]), 1))
        return jnp.asarray(scale * rng.standard_normal(shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _wave_pair(seed, train_input):
    jm = JW.WaveModeling(dim=C)
    v = _redraw(jm.init(jax.random.PRNGKey(seed), jnp.asarray(train_input)), seed)
    tm = TW.WaveModeling(C, device="cpu")
    tm.load_state_dict(state_dict_from_jax(v, ".".join), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8), (3, 7, 11)])
def test_wave_modeling_matches_jax(train, shape):
    B, H, W = shape
    x = np.random.default_rng(1).standard_normal((B, H, W, C)).astype(np.float32)
    jm, v, tm = _wave_pair(0, x)
    tm.train(train)
    if train:
        want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    got = tm(_nchw(x))
    assert got.shape == (B, 2 * C, H, W)
    _close(got, np.moveaxis(np.asarray(want), -1, 1), TOL)
    if train:
        new = state_dict_from_jax({"batch_stats": mut["batch_stats"]}, ".".join)
        sd = tm.state_dict()
        for k in ("theta_R_bn.running_mean", "theta_R_bn.running_var",
                  "theta_I_bn.running_mean", "theta_I_bn.running_var"):
            _close(sd[k], new[k].numpy(), STATS_TOL)
            assert not torch.equal(sd[k], state_dict_from_jax(v, ".".join)[k])   # they moved


def test_token_fcs_pair_consecutive_channels():
    """Output k of each grouped token FC reads input channels 2k and 2k + 1 only:
    the x cos and x sin halves of one wave channel k would be channels k and C + k."""
    tm = TW.WaveModeling(C, device="cpu", generator=torch.Generator().manual_seed(0))
    assert tm.tfc_h.weight.shape == (C, 2, 1, 7) and tm.tfc_w.weight.shape == (C, 2, 7, 1)
    x = torch.zeros(1, 2 * C, 1, 7)
    x[0, 3, 0, 3] = 1.0   # channel 3 feeds output 1 only
    out = tm.tfc_h(x)[0, :, 0, 3]
    assert out[1] != 0 and (out[[0, 2, 3, 4]] == 0).all()


def _labels():
    return {
        "one_each": np.eye(C, dtype=np.float32)[[0, 3, 4]],
        "several": np.array([[1, 0, 1, 1, 0], [0, 1, 0, 0, 1], [1, 1, 1, 1, 1]], np.float32),
        "one_empty": np.array([[0, 0, 0, 0, 0], [0, 1, 0, 0, 1], [1, 0, 0, 0, 0]], np.float32),
        "all_empty": np.zeros((3, C), np.float32),
    }


@pytest.fixture(scope="module")
def predictor_case():
    """JAX's predictor at representation_size 2 * 8 * 8 (the canonical grid is
    8 x 8): loss, accuracy and gradients on three CAM geometries, in f32 and, in
    training mode, also in f64."""
    F = 128
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((3, C, F))).astype(np.float32)
    cams = {hw: rng.random((3,) + hw + (C,)).astype(np.float32)
            for hw in ((8, 8), (3, 3), (5, 7))}
    jm = JW.ClassPredictorWavecam(num_classes=C, representation_size=F)
    v = _redraw(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.ones((3, C)),
                        jnp.asarray(cams[(8, 8)])), 3)

    def run(hw, label, train, dtype):
        def loss_fn(variables, xx, cc):
            if train:
                (loss, acc), mut = jm.apply(variables, xx, jnp.asarray(label, dtype), cc,
                                            train=True, mutable=["batch_stats"])
            else:
                (loss, acc), mut = jm.apply(variables, xx, jnp.asarray(label, dtype), cc), None
            return loss, (acc, mut)

        vv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), v)
        (loss, (acc, mut)), grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                                       has_aux=True)(
            vv, jnp.asarray(x, dtype), jnp.asarray(cams[hw], dtype))
        grads = jax.tree_util.tree_map(np.asarray, grads)
        return float(loss), float(acc), grads, mut

    out = {}
    for hw in cams:
        for name, label in _labels().items():
            for train in (False, True):
                out[hw, name, train, "f32"] = run(hw, label, train, jnp.float32)
                if train:
                    with jax.enable_x64(True):
                        out[hw, name, train, "f64"] = run(hw, label, train, jnp.float64)
    return dict(F=F, x=x, cams=cams, v=v, out=out)


def _port_predictor(case):
    tm = TW.ClassPredictorWavecam(C, case["F"], device="cpu")
    tm.load_state_dict(wavecam_predictor_state_dict_from_jax(case["v"]), strict=True)
    return tm


# a conv bias just before a BatchNorm that normalises with batch statistics has
# no effect on the output: its gradient is 0 up to rounding
ZERO_IN_TRAINING = ("wave.theta_R_conv.bias", "wave.theta_I_conv.bias")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("label", list(_labels()))
@pytest.mark.parametrize("hw", [(8, 8), (3, 3), (5, 7)])
def test_predictor_loss_acc_grads_match_jax(predictor_case, hw, label, train):
    """Loss and accuracy in f32. The gradients in f32 in eval mode; in training
    mode in f64, since the BatchNorms' batch statistics make the f32 gradients
    of the phase convs cancel (f32 rounding moves them by a few 1e-4 of their
    largest entry on either side)."""
    case = predictor_case
    want_loss, want_acc, _, mut = case["out"][hw, label, train, "f32"]
    dtype = torch.float64 if train else torch.float32
    _, _, (g_vars, g_x, g_cams), _ = case["out"][hw, label, train, "f64" if train else "f32"]
    tm = _port_predictor(case).train(train)
    x = torch.from_numpy(case["x"].copy())
    cams = _nchw(case["cams"][hw])
    labels = torch.from_numpy(_labels()[label])
    with torch.no_grad():
        loss, acc = tm(x, labels, cams)
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=1e-7)
    assert float(acc) == pytest.approx(want_acc, abs=1e-7)
    if label == "all_empty":
        assert float(loss) == 0.0 and float(acc) == 0.0
    if train:
        sd = tm.state_dict()
        new = state_dict_from_jax({"batch_stats": mut["batch_stats"]}, ".".join)
        for k, w in new.items():
            if k.endswith(("running_mean", "running_var")):
                _close(sd[k], w.numpy(), STATS_TOL)

    tm = _port_predictor(case).to(dtype).train(train)
    x, cams = x.to(dtype).requires_grad_(), cams.to(dtype).requires_grad_()
    loss, _ = tm(x, labels.to(dtype), cams)
    loss.backward()
    _close(x.grad, g_x, GRAD_TOL)
    _close(cams.grad, np.moveaxis(g_cams, -1, 1), GRAD_TOL)
    want = wavecam_predictor_state_dict_from_jax({"params": g_vars["params"]})
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in tm.named_parameters():
        if train and name in ZERO_IN_TRAINING:
            assert np.abs(want[name].numpy()).max() <= 1e-9 * largest, name
            assert p.grad.abs().max() <= 1e-9 * largest, name
        else:
            _close(p.grad, want[name].numpy(), GRAD_TOL)


def test_predictor_resizes_only_off_the_canonical_grid(monkeypatch):
    """At s x s (s = 32 for 2048) the CAM reaches the wave block as it is; any
    other size is resized bilinearly to s x s first."""
    tm = TW.ClassPredictorWavecam(C, 2048, device="cpu", generator=torch.Generator().manual_seed(0))
    seen = []
    tm.wave.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    x = torch.zeros(2, C, 2048)
    label = torch.ones(2, C)
    cams = torch.rand(2, C, 32, 32)
    tm.eval()(x, label, cams)
    assert seen[-1] is cams
    small = torch.rand(2, C, 3, 4)
    tm(x, label, small)
    assert seen[-1].shape == (2, C, 32, 32)
    want = torch.nn.functional.interpolate(small, (32, 32), mode="bilinear", align_corners=False)
    assert torch.equal(seen[-1], want)


def test_state_dict_names():
    tm = TW.ClassPredictorWavecam(20, 2048, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    want = {"classifier": (20, 2048)}
    for b in ("theta_R", "theta_I"):
        want.update({f"wave.{b}_conv.weight": (20, 20, 1, 1), f"wave.{b}_conv.bias": (20,),
                     f"wave.{b}_bn.weight": (20,), f"wave.{b}_bn.bias": (20,),
                     f"wave.{b}_bn.running_mean": (20,), f"wave.{b}_bn.running_var": (20,),
                     f"wave.{b}_bn.num_batches_tracked": ()})
    want.update({"wave.fc_h.weight": (20, 20, 1, 1), "wave.fc_w.weight": (20, 20, 1, 1),
                 "wave.tfc_h.weight": (20, 2, 1, 7), "wave.tfc_w.weight": (20, 2, 7, 1),
                 "wave.w1.weight": (20, 20, 1, 1), "wave.w1.bias": (20,),
                 "wave.w2.weight": (20, 20, 1, 1), "wave.w2.bias": (20,)})
    assert shapes == want


def test_from_jax_round_trip():
    """JAX's own initial variables at the pipeline's shapes load strictly, every
    leaf lands on its key in the right layout, and the converted tensors come
    back out of the model unchanged."""
    jm = JW.ClassPredictorWavecam(20, 2048)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 2048)), jnp.ones((1, 20)),
        jnp.zeros((1, 32, 32, 20))))
    sd = wavecam_predictor_state_dict_from_jax(v)
    tm = TW.ClassPredictorWavecam(20, 2048, device="cpu")
    tm.load_state_dict(sd, strict=True)
    p, bs = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(tm.classifier.detach().numpy(), p["classifier_kernel"].T)
    np.testing.assert_array_equal(tm.wave.tfc_h.weight.detach().numpy(),
                                  p["wave"]["tfc_h"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tm.wave.theta_I_bn.weight.detach().numpy(),
                                  p["wave"]["theta_I_bn"]["scale"])
    np.testing.assert_array_equal(tm.wave.theta_R_bn.running_var.numpy(),
                                  bs["wave"]["theta_R_bn"]["var"])
    assert all(torch.equal(a, sd[k]) for k, a in tm.state_dict().items())


def test_predictor_builds_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.ClassPredictorWavecam(20, 2048)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.WaveModeling(20)
    a, b = (TW.ClassPredictorWavecam(20, 2048, device="cpu",
                                     generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert all(t.device.type == "cpu" for t in a.state_dict().values())
    assert all(torch.equal(u, w) for u, w in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert a.classifier.std().item() == pytest.approx(2048 ** -0.5, rel=0.05)
