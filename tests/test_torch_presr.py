"""K1' (the PRE_SR variant of the MiT block kernel) of the PyTorch port against
the JAX package: `fused_block_reference(h=, xs=)` against the JAX
`fused_block_pallas(h=, xs=, interpret=True)` and against `Block`
(`tests/test_pallas_attention.py:169-190`), `sr_reduce` against `sr_reduce_xla`,
and the `pre_sr` option of `FusedBlock`, `MixVisionTransformer` and `TSCD`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.mit import Block
from representationlearning_tpu.ops.pallas import mit_block as jmb
from representationlearning_tpu_torch.models.mit import FusedBlock
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.ops import mit_block as tmb

torch.set_num_threads(2)

# the geometries of tests/test_pallas_attention.py:178-179, with grids that the
# sr stride does not divide (19 % 8, 13 % 4)
GEOMETRIES = [(16, 64, 8, 1), (16, 128, 4, 2), (8, 320, 2, 5), (19, 64, 8, 1), (13, 128, 4, 2)]
# f32: the same math in another summation order; the JAX package's own bound
F32_ATOL = 2e-5


def torch_params(p: dict) -> dict:
    """The JAX kernel's flat param dict -> the port's, in torch layouts."""
    out = {}
    for k, v in p.items():
        v = np.asarray(v, np.float32)
        if k == "sr_kernel":
            v = v.transpose(3, 2, 0, 1)                     # HWIO -> OIHW
        elif k == "dw_kernel":
            v = v.transpose(2, 0, 1)[:, None]               # (3,3,hid) -> (hid,1,3,3)
        elif k.endswith("_kernel"):
            v = v.T                                         # (in, out) -> (out, in)
        out[k.replace("_kernel", "_weight").replace("_scale", "_weight")] = \
            torch.from_numpy(np.array(v))
    return out


def _setup(hw, C, sr, nh, seed):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((2, hw * hw, C)).astype(np.float32)
    blk = Block(C, nh, 4.0, sr, export_attn=False)
    v = blk.init(jax.random.PRNGKey(seed), jnp.asarray(tok), hw, hw)
    p = jmb.block_variables_to_fused(v["params"])
    p = {k: (jnp.asarray(rng.standard_normal(np.shape(a)).astype(np.float32) * 0.1
                         + (1.0 if k.endswith("_scale") else 0.0))
             if (k.endswith("_bias") or k.endswith("_scale")) else a)
         for k, a in p.items()}
    return tok, p, torch_params(p)


@pytest.mark.parametrize("hw,C,sr,nh", GEOMETRIES)
def test_pre_sr_block_matches_jax(hw, C, sr, nh):
    tok, p, tp = _setup(hw, C, sr, nh, seed=hw + C)
    xj, xt = jnp.asarray(tok), torch.from_numpy(tok)
    jh, jxs = jmb.sr_reduce_xla(xj, p, H=hw, W=hw, sr=sr, dtype=jnp.float32)
    want = np.asarray(jmb.fused_block_pallas(xj, p, H=hw, W=hw, sr=sr, nh=nh, h=jh, xs=jxs,
                                             interpret=True))
    h, xs = tmb.sr_reduce(xt, tp, H=hw, W=hw, sr=sr)
    assert h.shape == (2, hw * hw, C) and xs.shape == (2, (hw // sr) ** 2, C)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=F32_ATOL)
    got = tmb.fused_block_reference(xt, tp, H=hw, W=hw, sr=sr, nh=nh, h=h, xs=xs)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    # the variant computes the same function as the block without it
    plain = tmb.fused_block_reference(xt, tp, H=hw, W=hw, sr=sr, nh=nh)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=F32_ATOL)
    # on a CPU tensor the dispatcher is the plain version, bit for bit
    tmb.reset_launches()
    assert torch.equal(tmb.fused_block(xt, tp, H=hw, W=hw, sr=sr, nh=nh, h=h, xs=xs), got)
    assert sum(tmb.LAUNCHES.values()) == 0


def test_pre_sr_block_runs_neither_the_front_ln_nor_sr_conv():
    """The piece sequence with h, xs given: one ln_stats (LN2), five linears
    without an LN prologue on q and kv, no sr_conv."""
    from types import SimpleNamespace

    hw, C, sr, nh = 16, 64, 8, 1
    tok, _, tp = _setup(hw, C, sr, nh, seed=1)
    xt = torch.from_numpy(tok)
    calls = []

    def rec(name):
        def run(*a, **kw):
            calls.append((name, kw.get("stats") is not None))
            return getattr(tmb, name + "_reference")(*a, **kw)
        return run

    ops = SimpleNamespace(**{n: rec(n) for n in tmb.LAUNCHES})
    h, xs = tmb.sr_reduce(xt, tp, H=hw, W=hw, sr=sr)
    kw = dict(H=hw, W=hw, sr=sr, nh=nh, dtype=torch.float32, export=False)
    tmb._block(xt, tp, ops=ops, h=h, xs=xs, **kw)
    assert calls == [("linear", False), ("linear", False), ("attention", False),
                     ("linear", False), ("ln_stats", False), ("linear", True),
                     ("dwconv_gelu", False), ("linear", False)]
    calls.clear()
    tmb._block(xt, tp, ops=ops, **kw)
    assert [c[0] for c in calls].count("ln_stats") == 3 and ("sr_conv", False) in calls


def test_pre_sr_refuses_what_the_variant_does_not_cover():
    tok, _, tp = _setup(8, 64, 1, 1, seed=2)
    xt = torch.from_numpy(tok)
    with pytest.raises(ValueError, match="sr > 1"):
        tmb.fused_block_reference(xt, tp, H=8, W=8, sr=1, nh=1, h=xt, xs=xt)
    with pytest.raises(ValueError, match="come together"):
        tmb.fused_block_reference(xt, tp, H=8, W=8, sr=2, nh=1, h=xt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_module_pre_sr(dtype):
    """`FusedBlock(pre_sr=True)` against `pre_sr=False` on the same weights; a
    grid below the stride goes through the variant too, with no key token."""
    g = torch.Generator().manual_seed(0)
    a = FusedBlock(64, 1, 4.0, 8, dtype=dtype, pre_sr=True).eval()
    b = FusedBlock(64, 1, 4.0, 8, dtype=dtype).eval()
    b.load_state_dict(a.state_dict())
    assert list(a.state_dict()) == list(b.state_dict())
    for hw in (19, 4):
        x = torch.randn(2, hw * hw, 64, generator=g)
        with torch.no_grad():
            got, _ = a(x, hw, hw)
            want, _ = b(x, hw, hw)
        # bf16: the conv of the front hands on a bf16 result where the block's own
        # front keeps f32: one rounding more, a few bf16 spacings at the output
        tol = F32_ATOL if dtype == torch.float32 else 2e-2 * want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol)


def test_tscd_pre_sr_matches_tscd():
    g = torch.Generator().manual_seed(0)
    a = TSCD("mit_b0", 21, fused_blocks=True, pre_sr=True, generator=g, device="cpu").eval()
    b = TSCD("mit_b0", 21, fused_blocks=True, device="cpu").eval()
    b.load_state_dict(a.state_dict())
    n = sum(getattr(m, "pre_sr", False) and m.sr_ratio > 1 for m in a.modules())
    assert n == 6 and not any(getattr(m, "pre_sr", False) for m in b.modules())
    x = torch.randn(2, 3, 64, 64, generator=g)
    with torch.no_grad():
        got, want = a(x), b(x)
    for u, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])):
        np.testing.assert_allclose(u.numpy(), w.numpy(), atol=1e-4)
