"""The HRFormer backbone (`models/hrt.py`) and `HRNetFusion("hrt_*")` against the
JAX package on the same weights (the port's state_dict through `convert_hrt` and
`convert_rssformer`, both strict) and numpy-seeded 64 x 64 inputs, f32:
- eval: the backbone's four maps and the probabilities within 2e-4 (of max(1,
  the largest magnitude); the bound of tests/test_parity_torch_e2e.py:21);
- `ISASelfAttention` at token grids that are not multiples of the window, and
  `HRTFuseDown` at one to three steps, within 2e-5 (one block's bound);
- the names: `convert_hrt` consumes every entry, and `from_jax` gives the
  state_dict back bit for bit;
- training mode with drop path at 0 (the two libraries' draws cannot agree): the
  CGFL losses through `segmentation_loss_aux` within 1e-5 relative, the gradient
  norm of each top-level module within 1e-3 relative, the BatchNorm statistics
  within 1e-4 of max(their largest entry, 1e-3) (tests/test_torch_train_rssformer.py
  holds the HRNetV2 step to 2e-4, 1e-2 and 1e-3; this step at random weights is
  calmer);
- the flags the HRFormer has no place for, the stochastic-depth schedule, and
  `hrt_base_win13`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrt_common import hrt_variables, jitter, nchw, nhwc
from representationlearning_tpu.convert.torch2jax import convert_hrt, state_dict_to_numpy
from representationlearning_tpu.models import hrt as JHRT
from representationlearning_tpu.models.rssformer import HRNetFusion as JHRNetFusion
from representationlearning_tpu_torch.convert.from_jax import rssformer_state_dict_from_jax
from representationlearning_tpu_torch.losses.cgfl import segmentation_loss_aux
from representationlearning_tpu_torch.models import hrt as THRT
from representationlearning_tpu_torch.models.layers import DropPath
from representationlearning_tpu_torch.models.rssformer import HRNetFusion

torch.set_num_threads(2)

ATOL = 2e-4
BLOCK_TOL = 2e-5
LOSS_RTOL, NORM_RTOL, STATS_TOL = 1e-5, 1e-3, 1e-4
B, SIDE, CLASSES = 2, 64, 7
LOSS_CONFIG = {"ce": {}}


def _model(**kw):
    return HRNetFusion("hrt_small", CLASSES, device="cpu",
                       generator=torch.Generator().manual_seed(0), **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, SIDE, SIDE, 3)).astype(np.float32)
    mask = rng.integers(-1, CLASSES, (B, SIDE, SIDE)).astype(np.int32)
    sd = jitter(_model(), 1).state_dict()
    return x, mask, sd, hrt_variables(sd)


@pytest.fixture(scope="module")
def jax_eval(setup):
    """One jit: the probabilities and the backbone's maps."""
    x, _, _, v = setup

    @jax.jit
    def run(v, x):
        probs, inter = JHRNetFusion("hrt_small", classes=CLASSES).apply(
            v, x, capture_intermediates=lambda mdl, _: isinstance(
                mdl, JHRT.HighResolutionTransformerNet), mutable=["intermediates"])
        return probs, inter["intermediates"]["backbone"]["__call__"][0]

    probs, feats = run(v, jnp.asarray(x))
    return np.asarray(probs), [np.asarray(f) for f in feats]


def _port(sd, **kw):
    m = _model(**kw).eval()
    m.load_state_dict(sd)
    return m


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def test_backbone_and_probabilities_match_jax(setup, jax_eval):
    x, _, sd, _ = setup
    want_probs, want_feats = jax_eval
    m = _port(sd)
    with torch.no_grad():
        feats = m.backbone(nchw(x))
        probs = m(nchw(x))
    assert [tuple(f.shape) for f in feats] == [(B, c, SIDE // s, SIDE // s) for c, s in
                                               zip((32, 64, 128, 256), (4, 8, 16, 32))]
    for f, w in zip(feats, want_feats):
        _close(nhwc(f), w, ATOL)
    assert 0.05 < want_probs.std()      # not a constant map
    np.testing.assert_allclose(nhwc(probs), want_probs, atol=ATOL)


@pytest.mark.parametrize("hw", [(9, 12), (7, 7), (2, 2), (15, 8)])
def test_isa_self_attention_at_non_multiples_matches_jax(hw):
    """Centre pad and depad at grids that are, and are not, window multiples."""
    H, W = hw
    C, nh = 32, 2
    port = THRT.ISASelfAttention(C, nh, 7).eval()
    names = {f"stage2.0.branches.0.0.attn.{k}": t for k, t in port.state_dict().items()}
    tree = convert_hrt(state_dict_to_numpy(names))["params"]["backbone"]["stage2_m0"]
    x = np.random.default_rng(H * 100 + W).standard_normal((2, H * W, C)).astype(np.float32)
    want = JHRT.ISASelfAttention(C, nh, 7).apply({"params": tree["branch0_block0"]["attn"]},
                                                 jnp.asarray(x), H, W)
    with torch.no_grad():
        got = port(torch.from_numpy(x), H, W)
    _close(got.numpy(), np.asarray(want), BLOCK_TOL)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_fuse_down_matches_jax(steps):
    cin, cout = 16, 24
    port = jitter(THRT.HRTFuseDown(cin, cout, steps), steps).eval()
    names = {f"stage4.0.fuse_layers.{steps}.0.{k}": t for k, t in port.state_dict().items()}
    v = convert_hrt(state_dict_to_numpy(names))
    sub = {c: v[c]["backbone"]["stage4_m0"][f"fuse{steps}_0"] for c in v}
    x = np.random.default_rng(steps).standard_normal((2, 16, 16, cin)).astype(np.float32)
    want = JHRT.HRTFuseDown(cin, cout, steps).apply(sub, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (2, cout, 16 >> steps, 16 >> steps)
    _close(nhwc(got), np.asarray(want), BLOCK_TOL)


def test_names_are_the_reference_converters(setup):
    """`convert_hrt` (strict) consumes every entry, including the reference's
    dead `norm2` and `num_batches_tracked`, which it drops; `from_jax` gives the
    state_dict back bit for bit."""
    _, _, sd, v = setup
    enc = {k.removeprefix("backbone.hrnet."): t for k, t in sd.items()
           if k.startswith("backbone.hrnet.")}
    enc["stage3.1.branches.2.0.norm2.weight"] = torch.ones(128)
    enc["stage3.1.branches.2.0.norm2.bias"] = torch.zeros(128)
    tree = convert_hrt(state_dict_to_numpy(enc), strict=True)
    flat, want = (jax.tree_util.tree_flatten_with_path(t["params"]["backbone"])[0]
                  for t in (tree, v))
    assert [p for p, _ in flat] == [p for p, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat, want))
    back = rssformer_state_dict_from_jax(v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k
    for name in ("backbone.hrnet.stage4.1.branches.3.1.attn.attn.out_proj.bias",
                 "backbone.hrnet.stage4.0.fuse_layers.3.0.2.3.running_var",
                 "backbone.hrnet.stage2.0.fuse_layers.0.1.1.weight",
                 "backbone.hrnet.transition3.3.0.0.weight",
                 "backbone.hrnet.layer1.0.downsample.0.weight"):
        assert name in sd


@pytest.fixture(scope="module")
def jax_train(setup):
    """JAX's training forward and gradient at drop path 0: losses, gradients and
    the new batch statistics."""
    x, mask, _, v = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JHRT.HRT_CONFIGS["hrt_small"], "drop_path_rate", 0.0)
        model = JHRNetFusion("hrt_small", classes=CLASSES, loss_config=LOSS_CONFIG)

        @jax.jit
        def step(params, batch_stats, x, y):
            def loss_fn(p):
                losses, mut = model.apply({"params": p, "batch_stats": batch_stats}, x, y,
                                          train=True, mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(0)})
                return sum(losses.values()), (losses, mut["batch_stats"])
            (_, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return losses, grads, stats

        losses, grads, stats = step(v["params"], v["batch_stats"], jnp.asarray(x),
                                    jnp.asarray(mask))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ({k: float(l) for k, l in losses.items()},
            rssformer_state_dict_from_jax({"params": np_tree(grads)}),
            rssformer_state_dict_from_jax({"batch_stats": np_tree(stats)}))


def _module_norms(named):
    sums = {}
    for k, g in named:
        top = ".".join(k.split(".")[:3]) if k.startswith("backbone.") else k.split(".")[0]
        sums[top] = sums.get(top, 0.0) + float(g.double().square().sum())
    return {k: s ** 0.5 for k, s in sums.items()}


def test_training_mode_matches_jax(setup, jax_train):
    x, mask, sd, _ = setup
    want_losses, want_grads, want_stats = jax_train
    m = _port(sd).train()
    for mod in m.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
    logit, aux = m(nchw(x))
    losses = segmentation_loss_aux(logit, torch.from_numpy(mask).long(), aux, LOSS_CONFIG, -1)
    sum(losses.values()).backward()
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        got = float(losses[k].detach())
        assert abs(got - w) <= LOSS_RTOL * abs(w), (k, got, w)
    got = _module_norms((k, p.grad if p.grad is not None else torch.zeros_like(p))
                        for k, p in m.named_parameters())
    want = _module_norms((k, g) for k, g in want_grads.items()
                         if not k.endswith("num_batches_tracked"))
    assert set(got) == set(want) and len(got) > 10
    for k, w in want.items():
        assert abs(got[k] - w) <= NORM_RTOL * w or (w == 0 and got[k] == 0), (k, got[k], w)
    assert want["headaux"] == 0.0    # no CGFL loss reaches it
    missing = [k for k, p in m.named_parameters() if p.grad is None]
    assert all(k.startswith("headaux.") for k in missing)
    now = m.state_dict()
    for k, w in want_stats.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((now[k] - w).abs().max())
        assert err <= STATS_TOL * max(float(w.abs().max()), 1e-3), (k, err)
        assert not torch.equal(now[k], sd[k]), k       # moved once


@pytest.mark.parametrize("flag", ["fused_mlp", "fused_attn", "remat_transformer"])
def test_kernel_flags_raise_with_the_hrt_backbone(flag):
    with pytest.raises(ValueError, match=f"{flag}: the HRT backbone"):
        HRNetFusion("hrt_small", CLASSES, device="cpu", **{flag: True})


def test_drop_path_schedule_and_generator():
    """The rates rise linearly over the 14 blocks, two a module in order, as in
    JAX; a training forward draws its masks from the generator it is given."""
    m = _model()
    rates = [blk.drop_path.rate for s in (2, 3, 4) for mod in getattr(m.backbone.hrnet, f"stage{s}")
             for blocks in mod.branches[:1] for blk in blocks]
    np.testing.assert_allclose(rates, [0.2 * i / 13 for i in range(14)], rtol=1e-12)
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    m.train()
    a, b, c = (m(x, torch.Generator().manual_seed(s))[0] for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_hrt_base_win13_runs_one_forward():
    m = HRNetFusion("hrt_base_win13", CLASSES, device="cpu",
                    generator=torch.Generator().manual_seed(0)).eval()
    assert m.backbone.hrnet.stage4[0].branches[3][0].attn.window_size == 13
    with torch.no_grad():
        probs = m(torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(2)))
    assert probs.shape == (1, CLASSES, 64, 64) and torch.isfinite(probs).all()
    torch.testing.assert_close(probs.sum(1), torch.ones(1, 64, 64))
