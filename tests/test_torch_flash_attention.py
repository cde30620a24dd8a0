"""K4 of the PyTorch port (`ops/attention.py`) against the JAX package's flash
attention: the plain version that CPU tensors run, forward and the three
gradients, against the Pallas kernel in interpret mode at tileable shapes and
against `_xla_attention` at ragged ones; and `TSCD(use_flash=True)` at `mit_b0`
against the JAX model with the interpreter patched in, outputs and parameter
gradients."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import representationlearning_tpu.ops.pallas.attention as JA
from representationlearning_tpu.models.tscd import TSCD as JTSCD
from representationlearning_tpu_torch.convert.from_jax import (named_tree_from_jax,
                                                               tscd_state_dict_from_jax)
from representationlearning_tpu_torch.models import mit as tmit
from representationlearning_tpu_torch.models.tscd import TSCD
from representationlearning_tpu_torch.ops import attention as TA

torch.set_num_threads(2)

# f32 on both sides: the same products, summed tile by tile with an online softmax
# on the JAX side and in one softmax here (the JAX package's own test holds its
# kernel to 1e-4 forward, rtol 2e-4 / atol 2e-5 backward, test_pallas_attention.py:56,108)
FWD_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5

TILEABLE = [(2, 256, 256, 64), (3, 512, 64, 32), (1, 64, 16, 64)]
RAGGED = [(2, 100, 9, 64), (3, 36, 9, 64), (2, 70, 1, 32), (1, 400, 100, 64)]


def _inputs(shape, seed=0):
    BH, Nq, Nk, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Nq, D)).astype(np.float32),
            rng.standard_normal((BH, Nk, D)).astype(np.float32),
            rng.standard_normal((BH, Nk, D)).astype(np.float32),
            rng.standard_normal((BH, Nq, D)).astype(np.float32))


def _port(q, k, v, cot, scale, fn):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv, scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(q, k, v, cot, scale, fn):
    args = [jnp.asarray(a) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, scale), *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("shape", TILEABLE)
def test_plain_version_matches_the_pallas_kernel_interpreted(shape):
    q, k, v, cot = _inputs(shape)
    scale = shape[3] ** -0.5
    assert JA._tileable(shape[1], shape[2], 256, 256)
    want, wg = _jax(q, k, v, cot, scale, functools.partial(JA.flash_attention, interpret=True))
    TA.reset_launches()
    got, gg = _port(q, k, v, cot, scale, TA.flash_attention)
    assert TA.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}  # CPU tensors: plain version
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", RAGGED)
def test_plain_version_matches_xla_attention_at_ragged_shapes(shape):
    q, k, v, cot = _inputs(shape, seed=1)
    scale = shape[3] ** -0.5
    want, wg = _jax(q, k, v, cot, scale, JA._xla_attention)
    got, gg = _port(q, k, v, cot, scale, TA.flash_attention_reference)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_mha_flash_folds_heads_and_keeps_bf16():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 36, 32)).astype(np.float32)
    k = rng.standard_normal((2, 5, 9, 32)).astype(np.float32)
    v = rng.standard_normal((2, 5, 9, 32)).astype(np.float32)
    want = np.asarray(JA.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TA.mha_flash(tq, tk, tv, 0.2)
    assert got.shape == (2, 5, 36, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    # a strided view (heads of a Linear's output) gives the same
    strided = TA.mha_flash(tq.transpose(1, 2).contiguous().transpose(1, 2), tk, tv, 0.2)
    assert torch.equal(strided, got)
    bf = TA.mha_flash(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), 0.2)
    assert bf.dtype == torch.bfloat16
    # inputs rounded to bf16 (2^-9 relative), the result stored in bf16
    np.testing.assert_allclose(bf.float().numpy(), want, atol=3e-2)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 8, 64)
    for bad in ((q, q[:1], q[:1]), (q[..., :48], q[..., :48], q[..., :48]),
                (q, q.double(), q), (q.transpose(0, 1), q, q)):
        with pytest.raises((ValueError, TypeError), match="flash_attention"):
            TA._check(*bad)
    assert TA._check(q, q[:, :3].contiguous(), q[:, :3].contiguous()) == (2, 8, 3, 64)
    # the backward's plan depends on the shape (and the card's occupancy) only
    assert TA.bwd_plan(8, 6400, 100, 64, torch.float32, 1) == (64, 15)
    assert TA.bwd_plan(1, 1, 1, 64) == (16, 1)


def test_sr_attention_flash_branch_rules():
    """K4 runs where the block exports nothing and no probability is dropped
    (JAX `models/mit.py:100-102`); otherwise the plain composition."""
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(0))
    seen = []
    orig = tmit.mha_flash
    tmit.mha_flash = lambda *a: seen.append(a[0].shape) or orig(*a)
    try:
        flash = tmit.SRAttention(64, 2, sr_ratio=2, export_attn=False, use_flash=True)
        out, attn = flash.eval()(x, 8, 8)
        assert attn is None and out.shape == x.shape and seen == [(2, 2, 64, 32)]
        flash.train()(x, 8, 8)              # attn_drop == 0: still the kernel's branch
        assert len(seen) == 2
        tmit.SRAttention(64, 2, sr_ratio=2, export_attn=True, use_flash=True).eval()(x, 8, 8)
        drop = tmit.SRAttention(64, 2, export_attn=False, use_flash=True, attn_drop=0.1)
        drop.train()(x, 8, 8)
        assert len(seen) == 2               # exporting, or dropping in training: plain
        drop.eval()(x, 8, 8)
        assert len(seen) == 3
        plain = tmit.SRAttention(64, 2, sr_ratio=2, export_attn=False, use_flash=False)
        plain.load_state_dict(flash.state_dict())
        np.testing.assert_allclose(plain.eval()(x, 8, 8)[0].detach().numpy(),
                                   out.detach().numpy(), atol=1e-5)
    finally:
        tmit.mha_flash = orig


@pytest.fixture(scope="module")
def tscd_setup():
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    v = jax.jit(JTSCD(backbone="mit_b0", num_classes=6).init)(jax.random.PRNGKey(0),
                                                               jnp.asarray(x))
    return x, v


def _loss_and_grads_jax(model, v, x):
    def loss(params):
        cls_logits, seg, _, pred = model.apply({**v, "params": params}, x, train=False)
        return (cls_logits ** 2).mean() + (seg ** 2).mean() + (pred ** 2).mean()

    orig = JA.flash_attention
    JA.flash_attention = functools.partial(orig, interpret=True)
    try:
        return jax.value_and_grad(loss)(v["params"])
    finally:
        JA.flash_attention = orig


@pytest.mark.parametrize("remat", [False, True])
def test_tscd_use_flash_matches_jax_outputs_and_gradients(tscd_setup, remat):
    x, v = tscd_setup
    want, wg = _loss_and_grads_jax(JTSCD(backbone="mit_b0", num_classes=6, use_flash=True), v,
                                   jnp.asarray(x))
    m = TSCD("mit_b0", 6, use_flash=True, remat=remat, device="cpu").eval()
    m.load_state_dict(tscd_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v)))
    calls = []
    orig = tmit.mha_flash
    tmit.mha_flash = lambda *a: calls.append(a[0].shape[2:]) or orig(*a)
    try:
        cls_logits, seg, _, pred = m(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        loss = (cls_logits ** 2).mean() + (seg ** 2).mean() + (pred ** 2).mean()
        loss.backward()
    finally:
        tmit.mha_flash = orig
    # the six blocks of stages 1-3 (twice under remat: once more in the backward)
    assert calls[:6] == [(256, 32)] * 2 + [(64, 32)] * 2 + [(16, 32)] * 2
    assert len(calls) == (12 if remat else 6)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = named_tree_from_jax(jax.tree_util.tree_map(np.asarray, wg))
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want_grads)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=n)


# The forward kernel's plan (`flash_plan`, `fwd_smem_bytes`) at every geometry K4 runs at:
# the train step's six (each launched twice a step), the 512 x 512 forward's three, and
# the edges of the key tile, of one query row and of the grid's bh limit.
STEP_GEOMETRIES = [(8, 6400, 100), (16, 1600, 100), (40, 400, 100), (8, 576, 9), (16, 144, 9),
                   (40, 36, 9)]
EVAL_GEOMETRIES = [(8, 16384, 256), (16, 4096, 256), (40, 1024, 256)]
EDGE_GEOMETRIES = [(3, 1, nk) for nk in (1, 8, 9, 128, 129, 257)] + [(65535, 17, 100),
                                                                     (65535, 1, 257)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("shape", STEP_GEOMETRIES + EVAL_GEOMETRIES + EDGE_GEOMETRIES)
def test_forward_plan_fits_a_block(shape, D, dtype):
    BH, Nq, Nk = shape
    tiles = BH * -(-Nq // 16)
    for per_sm in (None, 1, 3):
        warps, blocks = TA.flash_plan(BH, Nq, Nk, D, dtype, per_sm)
        smem, slots = TA.fwd_smem_bytes(Nk, D, dtype == torch.bfloat16, warps)
        assert 1 <= warps <= TA.FWD_MAX_WARPS and 1 <= blocks <= tiles
        assert smem <= TA.SMEM_LIMIT == 227 * 1024
        assert slots * TA.fwd_key_tile(Nk) >= min(Nk, 2 * TA.fwd_key_tile(Nk))
        if per_sm:  # no more blocks than the card holds at once
            assert blocks <= per_sm * TA.H100_SMS
        assert TA.check_plan((warps, blocks), Nk, D, dtype) == (warps, blocks)
    # every plan the card might be given fits too
    for warps in range(1, TA.FWD_MAX_WARPS + 1):
        assert TA.fwd_smem_bytes(Nk, D, dtype == torch.bfloat16, warps)[0] <= TA.SMEM_LIMIT


def test_forward_plan_fills_the_card_at_the_train_step():
    """Every geometry of the step gives each SM work (or each query tile its own warp),
    where the parent kernel launched 40 blocks at (40, 36, 9)."""
    for BH, Nq, Nk in STEP_GEOMETRIES:
        tiles = BH * -(-Nq // 16)
        warps, blocks = TA.flash_plan(BH, Nq, Nk, 64, torch.float32, 2)
        assert blocks * warps >= min(tiles, TA.H100_SMS), (BH, Nq, Nk)
        assert blocks >= min(TA.H100_SMS, -(-tiles // warps)), (BH, Nq, Nk)


@pytest.mark.parametrize("Nk,tile", [(1, 16), (8, 16), (9, 16), (16, 16), (17, 32), (100, 112),
                                     (104, 112), (128, 128), (129, 128), (256, 128),
                                     (257, 128), (1024, 128)])
def test_forward_key_tile_depends_on_nk_alone(Nk, tile):
    """So every plan, dtype and head width at one Nk sums the keys in the same tiles."""
    assert TA.fwd_key_tile(Nk) == tile
    nkt = -(-Nk // tile)
    for D in (32, 64):
        for bf16 in (False, True):
            for warps in (1, 4, 8):
                smem, slots = TA.fwd_smem_bytes(Nk, D, bf16, warps)
                assert slots == nkt or (slots == 2 and nkt > 2)   # resident, or streamed


@pytest.mark.parametrize("plan", [(0, 4), (9, 4), (4, 0), (4, -1), (1, 2, 3), (4,), "ab", None])
def test_flash_attention_refuses_an_invalid_plan(plan):
    q = torch.zeros(2, 20, 64)
    k = torch.zeros(2, 9, 64)
    if plan is None:   # no plan: the plain version on CPU tensors
        assert TA.flash_attention(q, k, k, 0.125, plan=plan).shape == q.shape
        return
    with pytest.raises(ValueError, match="plan"):
        TA.flash_attention(q, k, k, 0.125, plan=plan)
    assert TA.flash_attention(q, k, k, 0.125, plan=(4, 1)).shape == q.shape


# The backward kernel's plan (`bwd_plan`, `bwd_smem_bytes`, `check_bwd_plan`) at the train
# step's six geometries, the 512 x 512 forward's three, one query and one key, and key
# counts around the kernel's key tile of 128 (one tile, two, a tile and one key).
BWD_GEOMETRIES = STEP_GEOMETRIES + EVAL_GEOMETRIES + [(1, 1, 1)] + [
    (3, 70, nk) for nk in (1, 100, 128, 129, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("shape", BWD_GEOMETRIES)
def test_backward_plan_fits_a_block(shape, D, dtype):
    BH, Nq, Nk = shape
    bf16 = dtype == torch.bfloat16
    units = BH * -(-Nk // TA.BWD_KEYS)
    for per_sm in (None, 1, 2, 3):
        rows, shares = TA.bwd_plan(BH, Nq, Nk, D, dtype, per_sm)
        tiles = -(-Nq // rows)
        assert rows in TA.BWD_ROWS and 1 <= shares <= tiles
        assert TA.bwd_smem_bytes(Nk, D, bf16, rows) <= TA.SMEM_LIMIT == 227 * 1024
        cap = (per_sm or TA._bwd_blocks_per_sm_estimate(Nk, D, bf16, rows)) * TA.H100_SMS
        # one wave: no more blocks than the card holds at once, unless every block has one
        # (bh, key tile) to itself; and no run longer than one wave needs
        assert units * shares <= max(cap, units)
        longest = -(-tiles // shares)
        assert longest == -(-tiles // max(1, min(tiles, cap // units)))
        # a function of the shape: the same plan again, and the kernel takes it
        assert TA.bwd_plan(BH, Nq, Nk, D, dtype, per_sm) == (rows, shares)
        assert TA.check_bwd_plan((rows, shares), Nq, Nk, D, dtype) == (rows, shares)
        for bad in ((rows, 0), (rows, tiles + 1), (8, 1), (128, 1), (rows,), "ab"):
            with pytest.raises(ValueError, match="plan"):
                TA.check_bwd_plan(bad, Nq, Nk, D, dtype)
    # every tile height the kernel takes fits
    for rows in TA.BWD_ROWS:
        assert TA.bwd_smem_bytes(Nk, D, bf16, rows) <= TA.SMEM_LIMIT
    floats = TA.bwd_workspace_floats(BH, Nq, Nk, D, 1)
    assert floats == (BH * -(-Nk // 128) * Nq * D if Nk > 128 else 0)


@pytest.mark.parametrize("shape", STEP_GEOMETRIES)
def test_backward_plan_fills_the_card_at_the_train_step(shape):
    """f32, hd 64, the occupancy the card reports for the chosen tile (one block an SM at
    Nk 100): every SM has a block but for the rounding of the runs, and a bh's dk / dv
    shares stay a few MB where the parent kernel wrote one a 64-row tile (41 MB at
    (8, 6400, 100))."""
    BH, Nq, Nk = shape
    rows, _ = TA.bwd_plan(BH, Nq, Nk, 64, torch.float32)
    per_sm = 1 if Nk > 64 else TA._bwd_blocks_per_sm_estimate(Nk, 64, False, rows)
    rows, shares = TA.bwd_plan(BH, Nq, Nk, 64, torch.float32, per_sm)
    tiles = -(-Nq // rows)
    longest = -(-tiles // shares)
    assert BH * shares >= min(TA.H100_SMS, BH * tiles) * longest / (longest + 1)
    assert 4 * TA.bwd_workspace_floats(BH, Nq, Nk, 64, shares) <= 8e6


@pytest.mark.parametrize("shape", TILEABLE + RAGGED)
def test_flash_backward_on_cpu_matches_jax(shape):
    """`flash_backward` on CPU tensors (its plain version) against the JAX package's
    backward: the Pallas kernel interpreted at tileable shapes, `_xla_attention` else."""
    q, k, v, cot = _inputs(shape, seed=4)
    scale = shape[3] ** -0.5
    jfn = functools.partial(JA.flash_attention, interpret=True) \
        if JA._tileable(shape[1], shape[2], 256, 256) else JA._xla_attention
    _, wg = _jax(q, k, v, cot, scale, jfn)
    tq, tk, tv, tc = (torch.from_numpy(a) for a in (q, k, v, cot))
    o = TA.flash_attention_reference(tq, tk, tv, scale)
    lse = torch.logsumexp(tq @ tk.transpose(-1, -2) * scale, dim=-1)
    TA.reset_launches()
    got = TA.flash_backward(tq, tk, tv, o, lse, tc, scale, plan=(16, 1))
    assert TA.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}   # CPU tensors: plain version
    for a, b in zip(got, wg):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("plan", [(8, 1), (16, 0), (16, 3), (64, 2), (16, 1, 1), (16,), "ab"])
def test_flash_backward_refuses_an_invalid_plan(plan):
    """Checked on any device: Nq = 20 has two 16-row tiles and one of 32 or 64."""
    q, k = torch.zeros(2, 20, 64), torch.zeros(2, 9, 64)
    lse = torch.zeros(2, 20)
    with pytest.raises(ValueError, match="plan"):
        TA.flash_backward(q, k, k, q, lse, q, 0.125, plan=plan)
    dq, dk, dv = TA.flash_backward(q, k, k, q, lse, q, 0.125, plan=(16, 2))
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
