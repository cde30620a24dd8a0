"""DRFL's Softnet of the PyTorch port (`models/dcl.py`) against the JAX package
(`representationlearning_tpu/models/dcl.py`): the transposed convolution at
(4, 2, 1) and (3, 1, 1), every submodule, the basic block in training with its
running statistics, the gated ViT blocks self and cross, both transformers, the
pixel discriminator and the whole `Softnet` (all five outputs), in f32 within
2e-4 of each output's largest entry; the converter's strictness both ways; the
side's `ValueError`.

JAX's variables are numpy draws over `jax.eval_shape` of `init` (fan-in normal
kernels, scales near 1, positive variances, biases and position embeddings
small), which keeps the sigmoid heads unsaturated and shows every parameter's
wiring; they reach the port through `dcl_state_dict_from_jax`, loaded with
strict=True. Inputs are numpy-seeded; the whole model runs at 64², batch 2, one
ViT layer (at 64² the deepest GroupNorms normalise 2 x 2 values a channel; at
32² they would output their bias alone)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import dcl as JD
from representationlearning_tpu_torch.convert.from_jax import (
    dcl_state_dict_from_jax, pixel_discriminator_state_dict_from_jax)
from representationlearning_tpu_torch.models import dcl as TD

torch.set_num_threads(2)

REL = 2e-4     # f32 end to end, of the largest magnitude
STATS = 1e-5   # running statistics after a training forward
SIDE = 64


def draw_variables(module, args, seed, **kw):
    """Numpy draws over the shapes of ``module.init(key, *args, **kw)``, each
    scaled to its role."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":   # fan-in normal: conv (kh, kw, in, out), dense (in, out)
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "prelu_alpha":
            return (0.25 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)   # biases, means, embeddings

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def close(got, want, rel=REL):
    """got (a port tensor, NCHW for 4-d) against want (JAX's array, NHWC)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float()
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _load(port, variables, prefix=""):
    """Convert ``variables`` (optionally under one more scope) and load them
    into ``port`` with strict=True."""
    if prefix:
        variables = {c: {prefix: t} for c, t in variables.items()}
    sd = dcl_state_dict_from_jax(variables)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    port.load_state_dict(sd, strict=True)
    return port


def _x(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 1, 1)])
def test_conv_transpose_matches_jax(k, s, p):
    """The transposed convolution through the converter's rule for ``up_conv``:
    (kh, kw, in, out) -> (in, out, kh, kw), both spatial axes flipped."""
    jm = JD.ConvTranspose(7, k, s, p)
    x = _x(k, 2, 8, 8, 5)
    v = draw_variables(jm, (jnp.asarray(x),), k)
    port = _load(torch.nn.ConvTranspose2d(5, 7, k, s, p), v, "up_conv")
    with torch.no_grad():
        close(port(nchw(x)), jm.apply(v, jnp.asarray(x)))


# name: (JAX module, port module, input shapes: NHWC for maps, (B, N, C) for tokens)
SUBMODULES = {
    "channel_attention": (lambda: JD.ChannelAttention(32), lambda: TD.ChannelAttention(32),
                          [(2, 6, 6, 32)]),
    "edge_attention": (lambda: JD.EdgeAttention(8), lambda: TD.EdgeAttention(8), [(2, 6, 7, 8)]),
    "encode_layer": (lambda: JD.EncodeLayer(16, 32), lambda: TD.EncodeLayer(16, 32),
                     [(2, 8, 8, 16)]),
    "decode_layer": (lambda: JD.DecodeLayer(32, 16, dropout=True),
                     lambda: TD.DecodeLayer(32, 16, use_dropout=True), [(2, 4, 4, 32)]),
    "end_layer_4_2": (lambda: JD.EndLayer(4, 2), lambda: TD.EndLayer(12, 4, 2), [(2, 5, 5, 12)]),
    "end_layer_3_1": (lambda: JD.EndLayer(3, 1), lambda: TD.EndLayer(12, 3, 1), [(2, 5, 5, 12)]),
    "gated_vit_self": (lambda: JD.GatedViTBlock(64, heads=4, mlp_dim=96),
                       lambda: TD.GatedViTBlock(64, heads=4, mlp_dim=96), [(2, 9, 64)]),
    "gated_vit_cross": (lambda: JD.GatedViTBlock(64, heads=4, mlp_dim=96, cross=True),
                        lambda: TD.GatedViTBlock(64, heads=4, mlp_dim=96, cross=True),
                        [(2, 9, 64), (2, 9, 64)]),
    "transformer": (lambda: JD.DCLTransformer(64, num_layers=2),
                    lambda: TD.DCLTransformer(64, 64, 4, num_layers=2), [(2, 32, 32, 64)]),
    "transformer_cross": (lambda: JD.DCLTransformer(1, cross=True, num_layers=1),
                          lambda: TD.DCLTransformer(64, 1, 4, cross=True, num_layers=1),
                          [(2, 32, 32, 64), (2, 32, 32, 64)]),
    "softnethead": (lambda: JD.Softnethead(), lambda: TD.Softnethead(),
                    [(2, 32, 32, 1), (2, 64, 64, 1)]),
}


@pytest.mark.parametrize("name", sorted(SUBMODULES))
def test_submodule_matches_jax(name):
    """Each submodule in eval mode (dropout off, running statistics)."""
    make_j, make_t, shapes = SUBMODULES[name]
    xs = [_x(i + 11, *s) for i, s in enumerate(shapes)]
    if name == "softnethead":   # its inputs are the sigmoid heads' maps
        xs = [0.5 * (x + 1.0) for x in xs]
    jm = make_j()
    v = draw_variables(jm, tuple(map(jnp.asarray, xs)), 3)
    want = jax.jit(jm.apply)(v, *map(jnp.asarray, xs))
    # a bare EndLayer's conv is scoped as Softnet's "end" is, for the converter's rule
    port = _load(make_t().eval(), v, "end" if name.startswith("end_layer") else "")
    with torch.no_grad():
        got = port(*[nchw(x) if x.ndim == 4 else torch.from_numpy(x) for x in xs])
    close(got, want)


def test_basic_block_in_training_matches_jax():
    """DCLBasicBlock in training: batch statistics normalise, and the running
    ones move with flax's momentum and the biased variance; then in eval."""
    jm = JD.DCLBasicBlock(16)
    x = _x(5, 2, 8, 8, 16)
    v = draw_variables(jm, (jnp.asarray(x),), 4)
    want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = _load(TD.DCLBasicBlock(16), v).train()
    with torch.no_grad():
        close(port(nchw(x)), want)
    stats = dcl_state_dict_from_jax({"batch_stats": mut["batch_stats"]})
    for k, w in stats.items():
        if "running" in k:
            torch.testing.assert_close(port.state_dict()[k], w, rtol=0, atol=STATS)
    port.eval()
    with torch.no_grad():
        close(port(nchw(x)), jm.apply({"params": v["params"], **mut}, jnp.asarray(x)))


def test_pixel_discriminator_matches_jax():
    jm = JD.PixelDiscriminator(16)
    x = _x(6, 2, 5, 5, 4)
    v = draw_variables(jm, (jnp.asarray(x),), 5)
    port = TD.PixelDiscriminator(4, 16, device="cpu").eval()
    port.load_state_dict(pixel_discriminator_state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        close(port(nchw(x)), jm.apply(v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def softnet():
    jm = JD.Softnet(3, 1)
    v = draw_variables(jm, (jnp.zeros((1, SIDE, SIDE, 3)),), 0)
    x = _x(1, 2, SIDE, SIDE, 3)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    port = TD.Softnet(3, 1, SIDE, device="cpu").eval()
    port.load_state_dict(dcl_state_dict_from_jax(v), strict=True)
    return dict(v=v, x=x, want=[np.asarray(w) for w in want], port=port)


@pytest.mark.parametrize("i,name", enumerate(["out", "out2", "bin", "d5_a", "d5sr_a"]))
def test_softnet_matches_jax(softnet, i, name):
    with torch.no_grad():
        got = softnet["port"](nchw(softnet["x"]))
    assert len(got) == 5
    close(got[i], softnet["want"][i])
    if name in ("out", "out2", "bin"):   # sigmoid heads, unsaturated at these weights
        assert 0.0 < float(got[i].min()) and float(got[i].max()) < 1.0


def test_names_are_jax_scopes(softnet):
    keys = set(softnet["port"].state_dict())
    assert {"firstConv.weight", "encode1.basic.conv1.weight", "encode1.basic.bn1.running_var",
            "encode1.down_gn.weight", "decode1.up_conv.weight", "decode1.prelu.weight",
            "transformer.block0.query.weight", "transformer.position_embeddings",
            "transformer2.position_embeddings2", "softnethead.end.conv.weight",
            "softnethead.firstConv.weight", "end2.conv.bias"} <= keys
    assert "transformer.position_embeddings2" not in keys
    leaves = jax.tree_util.tree_leaves(softnet["v"])
    n_bn = sum(k.endswith("num_batches_tracked") for k in keys)
    assert len(keys) == len(leaves) + n_bn   # every leaf one key, and the reverse


def test_converter_is_strict(softnet):
    """An extra leaf, a missing leaf, an unknown leaf name or collection: each
    refused, by the converter or by the strict load."""
    v = softnet["v"]
    port = TD.Softnet(3, 1, SIDE, device="cpu")
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port.load_state_dict(dcl_state_dict_from_jax(extra), strict=True)
    missing = {"params": {k: t for k, t in v["params"].items() if k != "end2"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(RuntimeError, match="Missing key"):
        port.load_state_dict(dcl_state_dict_from_jax(missing), strict=True)
    odd = {"params": {**v["params"], "end2": {"conv": {"gamma": np.zeros(1, np.float32)}}}}
    with pytest.raises(KeyError, match="gamma"):
        dcl_state_dict_from_jax(odd)
    with pytest.raises(KeyError, match="intermediates"):
        dcl_state_dict_from_jax({**v, "intermediates": {}})


def test_side_is_fixed_at_construction(softnet):
    with pytest.raises(ValueError, match="built for 64 x 64 .* got 96 x 96"):
        softnet["port"](torch.zeros(1, 3, 96, 96))
    with pytest.raises(ValueError, match="multiple of 32"):
        TD.Softnet(3, 1, 48, device="cpu")
