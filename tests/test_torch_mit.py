"""MiT modules of the PyTorch port against the JAX package on converted weights.

JAX variables go to the port through `state_dict_from_jax` (module level) or the
port's state_dict goes to JAX through `convert_mit` (the whole encoder); the same
numpy-seeded input runs through both. f32 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_mit, state_dict_to_numpy
from representationlearning_tpu.models import mit as jmit
from representationlearning_tpu_torch.convert.from_jax import state_dict_from_jax
from representationlearning_tpu_torch.models import mit as tmit
from representationlearning_tpu_torch.models.layers import init_weights

torch.set_num_threads(2)

# module outputs: f32 sums over K <= 4 * 512 in another order, plus flax's
# one-pass LayerNorm variance against torch's two-pass one
ATOL = 2e-5
# raw q.k logits and anything downstream of several blocks: the e2e bound of
# tests/test_parity_torch_e2e.py:21
ATOL_DEEP = 2e-4


def _tokens(seed, B, hw, C):
    return np.random.default_rng(seed).standard_normal((B, hw * hw, C)).astype(np.float32)


@pytest.mark.parametrize("hw,C,sr,nh", [(8, 64, 1, 1), (16, 64, 4, 2), (13, 128, 4, 2),
                                        (8, 160, 2, 5)])
def test_sr_attention_with_export_matches_jax(hw, C, sr, nh):
    """Output and the exported logits, query-pooled over sr x sr windows when
    sr > 1 (`mit.py:129-140`), including a grid the stride does not divide."""
    x = _tokens(hw + C, 2, hw, C)
    jm = jmit.SRAttention(C, nh, sr, export_attn=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), hw, hw)
    want, want_a = jm.apply(v, jnp.asarray(x), hw, hw)
    tm = tmit.SRAttention(C, nh, sr, export_attn=True).eval()
    tm.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got, a = tm(torch.from_numpy(x), hw, hw)
    Nk = (hw // sr) ** 2
    assert a.shape == (2, nh, Nk, Nk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), atol=ATOL_DEEP)


@pytest.mark.parametrize("hw,C,sr,nh,export", [(16, 64, 8, 1, False), (8, 512, 1, 8, True),
                                               (19, 64, 8, 1, True)])
def test_block_matches_jax(hw, C, sr, nh, export):
    x = _tokens(7, 2, hw, C)
    jm = jmit.Block(C, nh, 4.0, sr, export_attn=export)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), hw, hw)
    want, want_a = jm.apply(v, jnp.asarray(x), hw, hw)
    tm = tmit.Block(C, nh, 4.0, sr, export_attn=export).eval()
    tm.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got, a = tm(torch.from_numpy(x), hw, hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if export:
        np.testing.assert_allclose(a.numpy(), np.asarray(want_a), atol=ATOL_DEEP)
    else:
        assert a is None and want_a is None


def test_fused_block_shares_block_state_dict():
    """FusedBlock holds Block's submodules: identical state_dict keys and shapes,
    so one checkpoint serves both, and on the CPU both agree."""
    blk = tmit.Block(64, 2, 4.0, 4, export_attn=False).eval()
    fused = tmit.FusedBlock(64, 2, 4.0, 4).eval()
    sd = blk.state_dict()
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in fused.state_dict().items()}
    fused.load_state_dict(sd)
    x = torch.from_numpy(_tokens(2, 2, 8, 64))
    with torch.no_grad():
        a, _ = blk(x, 8, 8)
        b, _ = fused(x, 8, 8)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL)


@pytest.mark.parametrize("mode", ["all", "last2", "none"])
def test_mix_vision_transformer_mit_b0_matches_jax(mode):
    """The whole mit_b0 encoder in each collect_attns mode: the port's weights go
    to JAX through `convert_mit`; stage features (NCHW vs NHWC) and every
    exported map must agree."""
    tm = tmit.make_mit("mit_b0", collect_attns=mode).eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    v = convert_mit(state_dict_to_numpy(tm.state_dict()))
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(np.float32)
    feats, attns = jmit.make_mit("mit_b0", collect_attns=mode).apply(v, jnp.asarray(x))
    with torch.no_grad():
        tfeats, tattns = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(tattns) == len(attns) == {"all": 8, "last2": 2, "none": 0}[mode]
    for jf, tf in zip(feats, tfeats):
        np.testing.assert_allclose(tf.numpy().transpose(0, 2, 3, 1), np.asarray(jf),
                                   atol=ATOL_DEEP)
    for ja, ta in zip(attns, tattns):
        assert ta.shape == ja.shape
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL_DEEP)


@pytest.mark.parametrize("stage", [(64, 1, 8), (128, 2, 4), (320, 5, 2)])
def test_use_flash_block_matches_the_jax_block(stage):
    """A non-exporting `Block(use_flash=True)` (K4 under its attention; on CPU
    tensors the plain version) against the JAX block on converted weights, whose
    shapes here are no tile multiples and take `_xla_attention`."""
    C, nh, sr = stage
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, 16 * 16, C)).astype(np.float32)
    jb = jmit.Block(C, nh, 4.0, sr, export_attn=False, use_flash=True)
    v = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), 16, 16)
    want, none = jb.apply(v, jnp.asarray(x), 16, 16)
    tb = tmit.Block(C, nh, 4.0, sr, export_attn=False, use_flash=True).eval()
    tb.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)))
    with torch.no_grad():
        got, attn = tb(torch.from_numpy(x), 16, 16)
    assert none is None and attn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("hw,C,sr,nh,export", [(3, 64, 8, 1, False), (7, 64, 8, 1, True),
                                               (3, 128, 4, 2, False), (1, 320, 2, 5, True)])
def test_sr_attention_on_a_map_smaller_than_one_window_matches_jax(hw, C, sr, nh, export):
    """A map smaller than one sr x sr window (the small CAM forwards of a short
    crop): JAX's VALID conv leaves no key token, so the output is proj's bias and
    the exported map is empty; the port gives the same."""
    x = _tokens(hw + C + sr, 2, hw, C)
    jm = jmit.SRAttention(C, nh, sr, export_attn=export)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), hw, hw)
    want, want_a = jm.apply(v, jnp.asarray(x), hw, hw)
    tm = tmit.SRAttention(C, nh, sr, export_attn=export).eval()
    tm.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got, a = tm(torch.from_numpy(x), hw, hw)
    assert got.shape == want.shape == (2, hw * hw, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(tm.proj.bias.detach().numpy(),
                                                            got.shape), atol=ATOL)
    if export:
        assert a.shape == want_a.shape == (2, nh, 0, 0)
    else:
        assert a is None and want_a is None


@pytest.mark.parametrize("mode", ["last2", "none"])
def test_mix_vision_transformer_mit_b0_below_the_reduction_windows_matches_jax(mode):
    """The mit_b0 encoder on a 24 x 20 image: stage 1's 6 x 5 grid lies below its 8 x 8
    reduction window and stage 2's 3 x 3 below its 4 x 4; features and the exported
    maps against JAX's."""
    tm = tmit.make_mit("mit_b0", collect_attns=mode).eval()
    init_weights(tm, torch.Generator().manual_seed(3))
    v = convert_mit(state_dict_to_numpy(tm.state_dict()))
    x = np.random.default_rng(6).standard_normal((2, 24, 20, 3)).astype(np.float32)
    feats, attns = jmit.make_mit("mit_b0", collect_attns=mode).apply(v, jnp.asarray(x))
    with torch.no_grad():
        tfeats, tattns = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert [tuple(f.shape[2:]) for f in tfeats[:2]] == [(6, 5), (3, 3)]
    assert len(tattns) == len(attns)
    for jf, tf in zip(feats, tfeats):
        np.testing.assert_allclose(tf.numpy().transpose(0, 2, 3, 1), np.asarray(jf),
                                   atol=ATOL_DEEP)
    for ja, ta in zip(attns, tattns):
        assert ta.shape == ja.shape
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL_DEEP)
