"""The RSSFormer transformer modules of the PyTorch port against the JAX package,
module by module, on the same numpy-seeded inputs and on the port's weights taken
through `convert_hrnet` (the block's state_dict under ``stage2.0.transformer.``).
JAX maps are NHWC, the port's NCHW; tokens and windows have the same layout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.convert.torch2jax import convert_hrnet, state_dict_to_numpy
from representationlearning_tpu.models import rssformer_modules as jr
from representationlearning_tpu_torch.models import rssformer_modules as tr
from representationlearning_tpu_torch.ops import isa_attention as ti
from representationlearning_tpu_torch.ops import mlp_dwbn as tm

torch.set_num_threads(2)

# f32, one module: the same f32 math in another summation order
ATOL = 2e-5
# the whole block (LayerNorms, attention, FFN with three BatchNorms)
BLOCK_ATOL = 1e-4
DIM, HEADS = 16, 2


def _jitter(module, seed):
    """Noise on every bias, norm affine and BatchNorm statistic, so that their
    wiring shows; the weights keep their initialisation."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("bias", "running_mean")) or "norm" in name:
                t.add_(0.2 * torch.randn(t.shape, generator=g))
    return module


@pytest.fixture(scope="module")
def block():
    torch.manual_seed(0)
    return _jitter(tr.GeneralTransformerBlock(DIM, HEADS), 1).eval()


def _variables(block):
    sd = {f"stage2.0.transformer.{k}": v
          for k, v in state_dict_to_numpy(block.state_dict()).items()}
    tree = convert_hrnet(sd, strict=True)
    return {c: tree[c]["backbone"]["stage2_m0"]["transformer"] for c in ("params", "batch_stats")}


def _sub(v, *path):
    out = {}
    for c, t in v.items():
        try:
            for k in path:
                t = t[k]
            out[c] = t
        except KeyError:
            pass
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_window_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 16, 19, 5)).astype(np.float32)
    jp, jorig = jr.window_pad(jnp.asarray(x), 7)
    tp, torig = tr.window_pad(torch.from_numpy(x), 7)
    assert tuple(tp.shape) == jp.shape == (2, 21, 21, 5) and torig == jorig == (16, 19)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jw, tw = jr.window_partition(jp, 7), tr.window_partition(tp, 7)
    assert tuple(tw.shape) == (2 * 9, 49, 5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = tr.window_depad(tr.window_reverse(tw, 7, 2, 21, 21), torig, 7)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jr.window_depad(jr.window_reverse(jw, 7, 2, 21, 21), jorig, 7)))


def test_spatial_attention_matches_jax(block):
    v = _sub(_variables(block), "attn", "atrous_block1")
    x = np.random.default_rng(1).standard_normal((2, 9, 11, DIM)).astype(np.float32)
    want = np.asarray(jr.SpatialAttention().apply(v, jnp.asarray(x)))          # (B, H, W, 1)
    with torch.no_grad():
        got = block.attn.atrous_block1(_nchw(x))                                # (B, 1, H, W)
    np.testing.assert_allclose(got.numpy()[:, 0], want[..., 0], atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_mhca_matches_jax(block, fused):
    """Both branches of the port's Mhca against the JAX einsum branch; the fused
    one is K6's plain version here."""
    v = _sub(_variables(block), "attn", "attn")
    rng = np.random.default_rng(2)
    x, y = (rng.standard_normal((6, 49, DIM)).astype(np.float32) for _ in range(2))
    want = np.asarray(jr.Mhca(DIM, HEADS).apply(v, *(jnp.asarray(a) for a in (x, y, y))))
    m = tr.Mhca(DIM, HEADS, fused=fused).eval()
    m.load_state_dict(block.attn.attn.state_dict())
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in (x, y, y)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_mhca_fused_falls_to_the_einsum_branch_when_it_must(block):
    """Dropout in training is not K6's function; another key count than the
    query's is not the gate's, fused or not, and raises."""
    m = tr.Mhca(DIM, HEADS, dropout=0.5, fused=True)
    m.load_state_dict(block.attn.attn.state_dict())
    x = torch.randn(3, 9, DIM)
    for fused in (True, False):
        m.fused = fused
        with pytest.raises(ValueError, match="as many key tokens"):
            m.eval()(x, x[:, :5], x[:, :5])
    m.fused = True
    calls = []
    orig = tr.isa_attention_core
    tr.isa_attention_core = lambda *a: calls.append(1) or orig(*a)
    try:
        m.train()(x, x, x)
        assert not calls
        m.eval()(x, x, x)
        assert calls == [1]
    finally:
        tr.isa_attention_core = orig


@pytest.mark.parametrize("H,W", [(14, 14), (9, 12)])
def test_interlaced_pool_attention_matches_jax(block, H, W):
    """Includes a grid that 7 does not divide (centre padding) and the raw
    (B, N, C) -> (B, C, H, W) -> (B, H, W, C) reinterpretations."""
    v = _sub(_variables(block), "attn")
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((2, H * W, DIM)).astype(np.float32) for _ in range(2))
    want = np.asarray(jr.InterlacedPoolAttention2(DIM, HEADS).apply(
        v, jnp.asarray(x), jnp.asarray(y), H, W))
    with torch.no_grad():
        got = block.attn(torch.from_numpy(x), torch.from_numpy(y), H, W)
    assert got.shape == (2, H * W, DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_mlp_dwbn_matches_jax(block, fused):
    v = _sub(_variables(block), "mlp")
    H, W = 13, 10
    x = np.random.default_rng(4).standard_normal((2, H * W, DIM)).astype(np.float32)
    want = np.asarray(jr.MlpDWBN(4 * DIM, DIM, fused=fused).apply(v, jnp.asarray(x), H, W))
    m = tr.MlpDWBN(DIM, 4 * DIM, DIM, fused=fused).eval()
    m.load_state_dict(block.mlp.state_dict())
    tm.reset_launches()
    with torch.no_grad():
        got = m(torch.from_numpy(x), H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert sum(tm.LAUNCHES.values()) == 0


def test_mlp_dwbn_bf16_matches_jax_bf16(block):
    """dtype=bf16, both forms against JAX's: the convs (or the products of K5's
    plain version) take bf16 operands. 2e-2 of the largest magnitude, the bound
    of the port's other bf16 comparisons (a few bf16 spacings)."""
    v = _sub(_variables(block), "mlp")
    H, W = 13, 10
    x = np.random.default_rng(5).standard_normal((2, H * W, DIM)).astype(np.float32)
    for fused in (False, True):
        want = np.asarray(jr.MlpDWBN(4 * DIM, DIM, dtype=jnp.bfloat16, fused=fused).apply(
            v, jnp.asarray(x), H, W), np.float32)
        m = tr.MlpDWBN(DIM, 4 * DIM, DIM, dtype=torch.bfloat16, fused=fused).eval()
        m.load_state_dict(block.mlp.state_dict())
        with torch.no_grad():
            got = m(torch.from_numpy(x), H, W).float().numpy()
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())


def test_mlp_dwbn_training_call_takes_the_convs(block):
    m = tr.MlpDWBN(DIM, 4 * DIM, DIM, fused=True).train()
    before = m.norm2.running_mean.clone()
    out = m(torch.randn(2, 30, DIM), 5, 6)
    assert out.shape == (2, 30, DIM) and out.requires_grad
    assert not torch.equal(m.norm2.running_mean, before) and int(m.norm2.num_batches_tracked) == 1


@pytest.mark.parametrize("fused_mlp,fused_attn", [(False, False), (True, True)])
def test_general_transformer_block_matches_jax(block, fused_mlp, fused_attn):
    v = _variables(block)
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((2, 14, 10, DIM)).astype(np.float32) for _ in range(2))
    want = np.asarray(jr.GeneralTransformerBlock(DIM, HEADS, fused_mlp=fused_mlp).apply(
        v, jnp.asarray(x), jnp.asarray(y)))
    m = tr.GeneralTransformerBlock(DIM, HEADS, fused_mlp=fused_mlp, fused_attn=fused_attn).eval()
    m.load_state_dict(block.state_dict())
    ti.reset_launches()
    with torch.no_grad():
        got = m(_nchw(x), _nchw(y))
    assert got.shape == (2, DIM, 14, 10)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=BLOCK_ATOL)
    assert ti.LAUNCHES == {"isa_core": 0}


def test_flags_change_no_parameter_name(block):
    a = tr.GeneralTransformerBlock(DIM, HEADS, fused_mlp=True, fused_attn=True)
    assert list(a.state_dict()) == list(block.state_dict())
