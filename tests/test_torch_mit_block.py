"""Kernel K1 (one MiT block) of the PyTorch port against the JAX package.

The same numpy-seeded tokens and weights go through the JAX `fused_block_reference`
and `fused_block_pallas` (interpret mode on the CPU) and through the port's
`fused_block_reference` / `fused_block` (which, on a CPU tensor, runs the plain
version). Geometries are those of `tests/test_pallas_attention.py:156-157`,
including grids that the sr stride does not divide (19 % 8, 13 % 4).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.mit import Block
from representationlearning_tpu.ops.pallas import mit_block as jmb
from representationlearning_tpu_torch.ops import mit_block as tmb

torch.set_num_threads(2)

GEOMETRIES = [(16, 64, 8, 1), (16, 128, 4, 2), (8, 320, 2, 5), (8, 512, 1, 8),
              (19, 64, 8, 1), (13, 128, 4, 2)]
# f32: both sides do the same f32 math, summed in another order (XLA vs torch
# matmuls over K <= 4 * 512); 2e-5 is the JAX package's own fused-vs-Block bound
F32_ATOL = 2e-5
# raw logits are unscaled q.k sums over hd = 64 with |q|,|k| ~ 1-3: one more
# order of magnitude than the block output, as in test_pallas_attention.py:228
LOGIT_ATOL = 2e-4


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
        name = k.replace("_kernel", "_weight").replace("_scale", "_weight")
        out[name] = torch.from_numpy(np.array(v))
    return out


def _setup(hw, C, sr, nh, seed, export=False):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((2, hw * hw, C)).astype(np.float32)
    blk = Block(C, nh, 4.0, sr, export_attn=export)
    v = blk.init(jax.random.PRNGKey(seed), jnp.asarray(tok), hw, hw)
    p = jmb.block_variables_to_fused(v["params"])
    # non-trivial LayerNorm affines and biases, so their wiring is checked too
    p = {k: (jnp.asarray(rng.standard_normal(np.shape(a)).astype(np.float32) * 0.1
                         + (1.0 if k.endswith("_scale") else 0.0))
             if (k.endswith("_bias") or k.endswith("_scale")) else a)
         for k, a in p.items()}
    return tok, p, torch_params(p)


@pytest.mark.parametrize("hw,C,sr,nh", GEOMETRIES)
def test_fused_block_reference_matches_jax(hw, C, sr, nh):
    tok, p, tp = _setup(hw, C, sr, nh, seed=hw + C)
    want = np.asarray(jmb.fused_block_reference(jnp.asarray(tok), p, H=hw, W=hw, sr=sr, nh=nh))
    wantk = np.asarray(jmb.fused_block_pallas(jnp.asarray(tok), p, H=hw, W=hw, sr=sr, nh=nh,
                                              interpret=True))
    got = tmb.fused_block_reference(torch.from_numpy(tok), tp, H=hw, W=hw, sr=sr, nh=nh)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), wantk, atol=F32_ATOL)
    # on a CPU tensor the dispatcher is the plain version, bit for bit
    disp = tmb.fused_block(torch.from_numpy(tok), tp, H=hw, W=hw, sr=sr, nh=nh)
    assert torch.equal(disp, got)


def test_fused_block_export_matches_jax():
    hw, C, nh = 8, 512, 8
    tok, p, tp = _setup(hw, C, 1, nh, seed=3, export=True)
    want, want_attn = jmb.fused_block_reference(jnp.asarray(tok), p, H=hw, W=hw, sr=1, nh=nh,
                                                export=True)
    wantk, attnk = jmb.fused_block_pallas(jnp.asarray(tok), p, H=hw, W=hw, sr=1, nh=nh,
                                          export=True, interpret=True)
    got, attn = tmb.fused_block_reference(torch.from_numpy(tok), tp, H=hw, W=hw, sr=1,
                                          nh=nh, export=True)
    assert attn.shape == (2, nh, hw * hw, hw * hw) and attn.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(wantk), atol=F32_ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(attnk), atol=LOGIT_ATOL)


@pytest.mark.parametrize("hw,C,sr,nh,export", [(16, 64, 8, 1, False), (8, 512, 1, 8, True)])
def test_fused_block_bf16_matches_jax_bf16(hw, C, sr, nh, export):
    """bf16 operands / f32 accumulation (the headline's dtype) on a bf16 stream,
    port against JAX. Both round the same f32 operands to bf16, so they agree to
    f32 summation order except where an operand sits on a bf16 rounding
    boundary; the block output itself is stored in bf16, whose spacing at the
    output's magnitude (|out| < 8) is at most 2^-5: tolerance 1 bf16 ulp there.
    The logits are sums of hd = 64 products of bf16-rounded q and k; q comes out
    of an f32 LN + matmul summed in another order, so some q elements round to
    the neighbouring bf16 value (2^-8 relative) on one side: 2e-2 bounds a few
    such flips at |q_i k_i| <= 4."""
    tok, p, tp = _setup(hw, C, sr, nh, seed=7, export=export)
    xj = jnp.asarray(tok, jnp.bfloat16)
    xt = torch.from_numpy(tok).to(torch.bfloat16)
    want = jmb.fused_block_reference(xj, p, H=hw, W=hw, sr=sr, nh=nh, dtype=jnp.bfloat16,
                                     export=export)
    got = tmb.fused_block_reference(xt, tp, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.bfloat16,
                                    export=export)
    if export:
        (want, want_attn), (got, attn) = want, got
        np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=2e-2)
    assert got.dtype == torch.bfloat16
    w32 = np.asarray(want.astype(jnp.float32))
    assert np.abs(w32).max() < 8.0
    np.testing.assert_allclose(got.float().numpy(), w32, atol=2.0 ** -5)


@pytest.mark.parametrize("piece", ["ln_stats", "linear", "sr_conv", "attention",
                                   "dwconv_gelu", "dwconv_gelu/plan"])
def test_wrappers_on_cpu_are_the_plain_versions(piece):
    """Each kernel wrapper, given CPU tensors, returns its plain version's result
    bit for bit and launches nothing; `piece/plan` with a plan other than the
    wrapper's own."""
    piece, _, with_plan = piece.partition("/")
    g = torch.Generator().manual_seed(0)
    B, H, W, C, sr, nh = 2, 8, 8, 64, 2, 2
    N = H * W
    x = torch.randn(B, N, C, generator=g)
    st = tmb.ln_stats_reference(x)
    lw, lb = torch.randn(C, generator=g), torch.randn(C, generator=g)
    args = {
        "ln_stats": ((x,), {}),
        "linear": ((x, torch.randn(3 * C, C, generator=g), torch.randn(3 * C, generator=g)),
                   dict(stats=st, ln_w=lw, ln_b=lb)),
        "sr_conv": ((x, st, lw, lb, torch.randn(C, sr * sr * C, generator=g),
                     torch.randn(C, generator=g)), dict(H=H, W=W, sr=sr)),
        "attention": ((x, torch.randn(B, N // 4, 2 * C, generator=g)),
                      dict(nh=nh, export=True)),
        "dwconv_gelu": ((x, torch.randn(C, 1, 3, 3, generator=g), torch.randn(C, generator=g)),
                        dict(H=H, W=W)),
    }[piece]
    plan = {"dwconv_gelu": {"plan": (1, 3)}}[piece] if with_plan else {}
    tmb.reset_launches()
    got = getattr(tmb, piece)(*args[0], **args[1], **plan)
    want = getattr(tmb, piece + "_reference")(*args[0], **args[1])
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert sum(tmb.LAUNCHES.values()) == 0


def test_plain_pieces_match_textbook_torch():
    """The plain pieces against PyTorch's own ops: LayerNorm, softmax attention,
    depthwise conv + exact GELU (A&S erf is within 1.5e-7 of erf)."""
    g = torch.Generator().manual_seed(1)
    B, H, W, C, nh = 2, 6, 5, 32, 2
    x = torch.randn(B, H * W, C, generator=g) * 3 + 1
    st = tmb.ln_stats_reference(x)
    ln = torch.nn.functional.layer_norm(x, (C,), eps=1e-6)
    np.testing.assert_allclose(tmb._apply_ln(x, st, torch.ones(C), torch.zeros(C)).numpy(),
                               ln.numpy(), atol=1e-5)
    kv = torch.randn(B, 7, 2 * C, generator=g)
    out, _ = tmb.attention_reference(x, kv, nh=nh, dtype=torch.float32)
    q = x.reshape(B, -1, nh, C // nh).transpose(1, 2)
    k, v = (t.reshape(B, 7, nh, C // nh).transpose(1, 2) for t in kv.split(C, dim=-1))
    sdpa = torch.softmax(q @ k.transpose(-1, -2) * (C // nh) ** -0.5, -1) @ v
    np.testing.assert_allclose(out.numpy(), sdpa.transpose(1, 2).reshape(B, -1, C).numpy(),
                               atol=1e-5)
    w, b = torch.randn(C, 1, 3, 3, generator=g), torch.randn(C, generator=g)
    got = tmb.dwconv_gelu_reference(x, w, b, H=H, W=W)
    conv = torch.nn.functional.conv2d(x.transpose(1, 2).reshape(B, C, H, W), w, b,
                                      padding=1, groups=C)
    want = torch.nn.functional.gelu(conv).flatten(2).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_zero_key_geometry_gives_zero_attention():
    """A grid smaller than the sr stride has no keys: the attention output is
    zero, as in the TPU kernel (`mit_block.py:152-157`)."""
    tok, p, tp = _setup(4, 64, 8, 1, seed=11)
    want = np.asarray(jmb.fused_block_reference(jnp.asarray(tok), p, H=4, W=4, sr=8, nh=1))
    got = tmb.fused_block_reference(torch.from_numpy(tok), tp, H=4, W=4, sr=8, nh=1)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


# ------------------------------------------------- sr_conv's split along K
# (tokens a side, C, sr) of the sr > 1 blocks: the 512 x 512 forward at batch 8, the
# CAM forwards of the pseudo-label call and the train step at batch 16 (crop 320 at
# scales 1, 0.5, 1.5, and 0.3 of it), and a map smaller than one patch
_SR_STAGES = [(64, 8, 1), (128, 4, 2), (320, 2, 4)]            # C, sr, grid divisor
SR_GEOMETRIES = [(8, 128 // f, C, sr) for C, sr, f in _SR_STAGES]
SR_GEOMETRIES += [(16, side // 4 // f, C, sr) for side in (320, 160, 480, 96, 48, 144)
                  for C, sr, f in _SR_STAGES]
SR_GEOMETRIES += [(16, 3, 64, 8)]


@pytest.mark.parametrize("B,hw,C,sr", SR_GEOMETRIES)
def test_sr_conv_plan_cuts_k_into_whole_steps_once(B, hw, C, sr):
    """The plan is a function of (M, C, K) alone, its slices are whole K steps, none
    empty, and together they cover [0, K) once and in order: what makes the
    kernel's sum deterministic and complete."""
    M, K = B * (hw // sr) ** 2, sr * sr * C
    tile, slices = tmb.sr_conv_plan(M, C, K)
    assert (tile, slices) == tmb.sr_conv_plan(M, C, K)
    assert tile in (64, 128) and slices in tmb.sr_conv_slice_counts(K)
    cuts = tmb.sr_conv_slices(K, slices)
    assert len(cuts) == slices and cuts[0][0] == 0 and cuts[-1][1] == K
    for (a0, a1), (b0, _) in zip(cuts, cuts[1:] + [(K, K)]):
        assert a0 < a1 == b0 and (a1 - a0) % tmb.SR_K_STEP == 0
    blocks = max(1, -(-M // tmb.SR_TILE_M)) * -(-C // tile) * slices
    if M >= 2048:       # the 512 x 512 forward: at least one block for each of 132 SMs
        assert blocks >= 132
    if slices > 1:      # never more blocks than the next smaller cut would need
        assert blocks // slices * (slices - 1) < tmb.SR_TARGET_BLOCKS


@pytest.mark.parametrize("hw,C,sr,slices", [(16, 64, 8, 9), (16, 64, 8, 32), (13, 128, 4, 8),
                                            (9, 320, 2, 3), (9, 320, 2, 20), (8, 64, 4, 1)])
def test_sr_conv_sum_in_slice_order_matches_plain(hw, C, sr, slices):
    """Partial products of the K slices, added in slice order, then the bias: the
    kernel's order of summation, in plain PyTorch. Against the one-product plain
    version it differs by f32 rounding of sums of at most 4096 exact products of
    bf16 operands: 1e-4 of the largest magnitude, the card's tolerance."""
    g = torch.Generator().manual_seed(hw * C)
    x = torch.randn(2, hw * hw, C, generator=g) * 2 + 0.5
    args = (x, tmb.ln_stats_reference(x), torch.randn(C, generator=g) + 1.0,
            torch.randn(C, generator=g) * 0.1,
            (torch.randn(C, sr * sr * C, generator=g) * 0.05).to(torch.bfloat16),
            torch.randn(C, generator=g))
    want = tmb.sr_conv_reference(*args, H=hw, W=hw, sr=sr)
    got = tmb.sr_conv_sliced_reference(*args, H=hw, W=hw, sr=sr, slices=slices)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    if slices == 1:
        assert torch.equal(got, want)


# The f32 kernel's plans, (M, C, sr): the headline (8 x 512²: M 2,048 at every stage), the
# WSSS command lines' CAM forwards (batch 4 of 5 / 10 / 15 patches a side: M 100 / 400 / 900),
# their validation (96 x 128 at batch 1: 12 rows at stage 1, up to 24 with [x; flip x]), the
# edges of the tiles (M 1, 64 and 128 less and more one) at every MiT width that has sr > 1,
# and a grid larger than one wave (the CAM forward at 480² and batch 16: 3,600 rows)
_SR_F32_WIDTHS = [(32, 8), (64, 8), (128, 4), (160, 2), (320, 2)]   # C, sr of MiT-B0..B5
SR_F32_GEOMETRIES = [(M, C, sr) for M in (2048, 100, 400, 900, 12, 16, 20, 24)
                     for C, sr in [(64, 8), (128, 4), (320, 2)]]
SR_F32_GEOMETRIES += [(M, C, sr) for M in (1, 63, 64, 65, 127, 128, 129, 3600)
                      for C, sr in _SR_F32_WIDTHS]


@pytest.mark.parametrize("M,C,sr", SR_F32_GEOMETRIES)
def test_sr_conv_f32_plan_covers_the_product_in_one_wave(M, C, sr):
    """The f32 plan ((rows, columns), slices) is one the kernel takes: a function of the
    shapes; every K step in exactly one slice, none empty; at most 16 slices (the blocks of
    one cluster, the H100's largest); columns no wider than `sr_conv_columns`, and narrower
    only in 64-row tiles at the most slices K allows; the tiles cover M x C with less than
    a tile to spare;
    the card holds the grid's clusters in one wave (SR_WG_CLUSTERS) wherever the tiles fit
    one; the ring, the LayerNorm vectors and the barriers within SMEM_LIMIT, and the
    partials of the cluster's sum within the ring. At the headline at least 96 blocks."""
    f32 = torch.float32
    K = sr * sr * C
    plan = tmb.sr_conv_plan(M, C, K, f32)
    (rows, cols), slices = plan
    assert plan == tmb.sr_conv_plan(M, C, K, f32) == tmb.check_sr_conv_plan(plan, K, f32)
    assert rows in tmb.SR_WG_ROWS and cols in tmb.SR_WG_COLUMNS and cols <= tmb.sr_conv_columns(C)
    assert 1 <= slices <= tmb.SR_WG_MAX_SLICES == 16
    if cols < tmb.sr_conv_columns(C):
        most = K // (tmb.SR_WG_MIN_STEPS * tmb.SR_K_STEP)   # slices of the fewest K steps
        assert rows == 64
        assert slices == max(s for s in tmb.sr_conv_slice_counts(K, f32) if s <= most)
    cuts = tmb.sr_conv_slices(K, slices)
    assert len(cuts) == slices and all(k1 > k0 for k0, k1 in cuts)
    steps = [k for k0, k1 in cuts for k in range(k0, k1, tmb.SR_K_STEP)]
    assert steps == list(range(0, K, tmb.SR_K_STEP))
    mt, nt = -(-M // rows), -(-C // cols)
    assert mt * rows >= M > (mt - 1) * rows and nt * cols >= C > (nt - 1) * cols
    tiles = mt * nt
    if tiles <= tmb.SR_WG_CLUSTERS[0]:
        assert tiles <= tmb.SR_WG_CLUSTERS[slices - 1]
    else:
        assert slices == 1
    stages = tmb.sr_conv_stages((rows, cols))
    assert tmb.sr_conv_smem_bytes((rows, cols), f32) <= tmb.SMEM_LIMIT and stages >= 2
    assert (rows + tmb.SR_WG_MAX_SLICES - 1) * (cols + 8) * 4 <= stages * (rows + 2 * cols) * 128
    if M == 2048:
        assert tiles * slices >= 96


@pytest.mark.parametrize("plan", [((96, 64), 2), ((64, 48), 2), ((64, 64), 9), ((64, 64), 0),
                                  ((128, 64), 5), (64, 2), ((64, 64),), "plan", ((64, 32), 17)])
def test_sr_conv_refuses_an_f32_plan_the_kernel_does_not_take(plan):
    """An f32 plan is checked on any device: a tile the kernel lacks, more slices than a
    cluster holds (or K steps), none, a cut that leaves a slice empty (K = 8 steps in 5
    slices of 2) and a bf16 plan's form are refused; a plan it takes runs the plain
    version on the CPU."""
    g = torch.Generator().manual_seed(5)
    C, sr, H = 64, 2, 6
    x = torch.randn(2, H * H, C, generator=g)
    args = (x, tmb.ln_stats_reference(x), torch.randn(C, generator=g) + 1.0,
            torch.randn(C, generator=g) * 0.1, torch.randn(C, sr * sr * C, generator=g) * 0.05,
            torch.randn(C, generator=g))
    with pytest.raises(ValueError, match="plan"):
        tmb.check_sr_conv_plan(plan, sr * sr * C, torch.float32)
    with pytest.raises(ValueError, match="plan"):
        tmb.sr_conv(*args, H=H, W=H, sr=sr, dtype=torch.float32, plan=plan)
    got = tmb.sr_conv(*args, H=H, W=H, sr=sr, dtype=torch.float32, plan=((64, 64), 4))
    assert torch.equal(got, tmb.sr_conv_reference(*args, H=H, W=H, sr=sr, dtype=torch.float32))


@pytest.mark.parametrize("hw,C,sr,nh", [g for g in GEOMETRIES if g[2] > 1])
@pytest.mark.parametrize("cut", ["plan", "every"])
def test_sr_conv_f32_slice_order_in_the_block_matches_jax_block_math(hw, C, sr, nh, cut):
    """The block with `sr_conv` summed in the f32 kernel's order (`sr_conv_sliced_reference`
    at the K slices of the f32 plan, or at every slice count the f32 kernel takes) against
    JAX's `_block_math` in f32 ("taps", the TPU kernel's form) on the same numpy inputs,
    within this file's per-block bound."""
    f32 = torch.float32
    tok, p, tp = _setup(hw, C, sr, nh, seed=hw * sr + C)
    block = functools.partial(jmb._block_math, p=p, H=hw, W=hw, sr=sr, nh=nh, dtype=jnp.float32)
    want = np.asarray(jax.vmap(lambda xb: block(xb))(jnp.asarray(tok)))
    M, K = 2 * (hw // sr) ** 2, sr * sr * C
    counts = ([tmb.sr_conv_plan(M, C, K, f32)[1]] if cut == "plan"
              else tmb.sr_conv_slice_counts(K, f32))
    for slices in counts:
        ops = SimpleNamespace(**{**vars(tmb.PLAIN), "sr_conv": functools.partial(
            tmb.sr_conv_sliced_reference, slices=slices)})
        got = tmb._block(torch.from_numpy(tok), tp, H=hw, W=hw, sr=sr, nh=nh, dtype=f32,
                         export=False, ops=ops)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def _setup_hw(H, W, C, sr, nh, seed):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((1, H * W, C)).astype(np.float32)
    blk = Block(C, nh, 4.0, sr)
    v = blk.init(jax.random.PRNGKey(seed), jnp.asarray(tok), H, W)
    p = jmb.block_variables_to_fused(v["params"])
    p = {k: (jnp.asarray(rng.standard_normal(np.shape(a)).astype(np.float32) * 0.1
                         + (1.0 if k.endswith("_scale") else 0.0))
             if (k.endswith("_bias") or k.endswith("_scale")) else a)
         for k, a in p.items()}
    return tok, p, torch_params(p)


# (H, W) with sr = 2 giving Nk = (H // 2) * (W // 2) keys: none, one, the last count
# below the one-pass bound of the CUDA kernel, the bound, the first beyond, and 1024
@pytest.mark.parametrize("H,W,Nk", [(1, 1, 0), (3, 3, 1), (30, 34, 255), (33, 33, 256),
                                    (2, 514, 257), (65, 65, 1024)])
@pytest.mark.parametrize("nh", [1, 2])
def test_attention_reference_matches_jax_around_the_one_pass_bound(H, W, Nk, nh):
    """`attention_reference` is the oracle of both forms of the CUDA kernel. Here it
    is held, inside the block, to the JAX `fused_block_reference` at the key counts
    where the kernel changes form, with token counts that no query tile divides
    (1, 9, 1020, 1089, 1028, 4225) and both head widths (64 and 32). f32 on both
    sides, sums in another order: 2e-5, the per-block bound of this file."""
    assert (H // 2) * (W // 2) == Nk and tmb.ATTN_ONE_PASS_KEYS == 256
    tok, p, tp = _setup_hw(H, W, 64, 2, nh, seed=Nk + nh)
    want = np.asarray(jmb.fused_block_reference(jnp.asarray(tok), p, H=H, W=W, sr=2, nh=nh))
    got = tmb.fused_block_reference(torch.from_numpy(tok), tp, H=H, W=W, sr=2, nh=nh)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    # and on its own: the attention of the block's q and kv is a softmax over Nk keys
    q = torch.from_numpy(tok)
    kv = torch.from_numpy(np.random.default_rng(Nk).standard_normal((1, Nk, 128))
                          .astype(np.float32))
    out, logits = tmb.attention_reference(q, kv, nh=nh, dtype=torch.float32, export=True)
    assert out.shape == q.shape and logits.shape == (1, nh, H * W, Nk)
    if Nk == 0:
        assert not out.any()
    else:
        hd = 64 // nh
        k = kv[..., :64].reshape(1, Nk, nh, hd).transpose(1, 2)
        v = kv[..., 64:].reshape(1, Nk, nh, hd).transpose(1, 2)
        qh = q.reshape(1, -1, nh, hd).transpose(1, 2)
        want_out = torch.softmax(qh @ k.transpose(-1, -2) * hd ** -0.5, -1) @ v
        np.testing.assert_allclose(out.numpy(),
                                   want_out.transpose(1, 2).reshape(1, -1, 64).numpy(),
                                   atol=F32_ATOL)


# ------------------------------------------------- linear's plan of tiles
# (M, Nout, K) of every `linear` launch: the five of a block (q, kv, proj, fc1, fc2)
# at each stage of the 512 x 512 forward at batch 8 (the PRE_SR path's q and kv
# are the same products without the LayerNorm), and of the CAM forwards of the
# pseudo-label call and the train step at batch 16 (crop 320 at scales 1, 0.5, 1.5,
# and 0.3 of it): token counts no tile divides, kv of one key row an image
_LIN_STAGES = [(64, 8, 1), (128, 4, 2), (320, 2, 4), (512, 1, 4)]   # C, sr, grid divisor


def _linear_geometries():
    geos = set()
    for B, side in [(8, 512)] + [(16, s) for s in (320, 160, 480, 96, 48, 144)]:
        for C, sr, f in _LIN_STAGES:
            hw = side // 4 // f
            M, Mk = B * hw * hw, B * (hw // sr) ** 2
            geos |= {(M, C, C), (M, 4 * C, C), (M, C, 4 * C)}
            if Mk:
                geos.add((Mk, 2 * C, C))
    return sorted(geos)


LINEAR_GEOMETRIES = _linear_geometries()


@pytest.mark.parametrize("M,Nout,K", LINEAR_GEOMETRIES)
def test_linear_plan_picks_a_tile_the_kernel_has(M, Nout, K):
    """The plan is a function of (M, Nout, K) alone, names a tile the kernel is
    instantiated for, covers M and Nout with whole tiles and leaves no block
    empty, keeps the grid within the card's limit, and lets a block walk several M
    tiles only on the tile of which an SM holds one block. The wide tile covers
    Nout <= 256 in one column tile; a narrower tile where Nout > 64 is chosen only
    because a wider one would give too few blocks."""
    tile, per = tmb.linear_plan(M, Nout, K)
    assert (tile, per) == tmb.linear_plan(M, Nout, K)
    assert tile in tmb.LINEAR_TILES
    t = tmb.LINEAR_TILES.index(tile)
    rows, cols = tile
    mtiles, ctiles = -(-M // rows), -(-Nout // cols)
    groups = -(-mtiles // per)
    assert groups * per * rows >= M and (groups - 1) * per * rows < M
    assert ctiles * cols >= Nout and groups <= tmb.LINEAR_MAX_GROUPS
    assert 1 <= per <= tmb.LINEAR_MAX_PER
    if tmb.LINEAR_BLOCKS_PER_SM[t] > 1:
        assert per == 1
    if t == 2 and Nout <= 256:
        assert ctiles == 1
    blocks = [-(-M // r) * -(-Nout // c) for r, c in tmb.LINEAR_TILES]
    if t == 0 and Nout > 64:
        assert blocks[1] < 2 * tmb.LINEAR_SMS
    if t < 2 and Nout % 256 == 0:
        assert blocks[2] < tmb.LINEAR_WIDE_MIN_BLOCKS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_and_sr_conv_tiles_fit_shared_memory_with_either_operand_type(dtype):
    """Every tile of `linear` and of `sr_conv` fits the 227 KB a block may ask for with
    bf16 and with f32 operands (gemm.cu's `linear_smem` and `lwg_smem`, sr_conv.cu's
    `sr_smem`), an SM (228 KB, 1 KB a block reserved) holds the blocks of each `linear`
    tile that the plan counts on, and the plans at the headline's and the CAM forwards'
    geometries cover every token once with tiles that fit: bf16 M tiles in groups of
    `per`, f32 output tiles walked by at most one persistent block an SM."""
    f32 = dtype == torch.float32
    tiles = tmb.linear_tiles(dtype)
    per_sm = tmb.LINEAR_BLOCKS_PER_SM_F32 if f32 else tmb.LINEAR_BLOCKS_PER_SM
    smem = [tmb.linear_smem_bytes(t, dtype) for t in range(len(tiles))]
    if f32:   # the ring of 128-byte rows: 7, 4 and 8 slots of A, weights and their small half
        assert smem == [230592, 197824, 197824]
        assert [tmb.linear_stages(t, dtype) for t in (0, 1, 2)] == [7, 4, 8]
    else:
        assert smem == [55296, 74752, 186368]   # 54, 73, 182 KB, as gemm.cu notes
    assert len(per_sm) == len(tiles)
    for n, b in zip(per_sm, smem):
        assert b <= tmb.SMEM_LIMIT and n * (b + 1024) <= 228 * 1024
    sr_tiles = ([(r, c) for r in tmb.SR_WG_ROWS for c in tmb.SR_WG_COLUMNS] if f32
                else [64, 128])
    assert all(tmb.sr_conv_smem_bytes(t, dtype) <= tmb.SMEM_LIMIT for t in sr_tiles)
    for M, Nout, K in LINEAR_GEOMETRIES:
        tile, n = tmb.linear_plan(M, Nout, K, dtype)
        assert (tile, n) == tmb.linear_plan(M, Nout, K, dtype) and tile in tiles
        rows, cols = tile
        if f32:
            out_tiles = -(-M // rows) * -(-Nout // cols)
            assert 1 <= n <= min(out_tiles, tmb.LINEAR_SMS)
            assert n == min(out_tiles, tmb.LINEAR_SMS)   # no block idle, one wave at most
            continue
        groups = -(-(-(-M // rows)) // n)
        assert groups * n * rows >= M > (groups - 1) * n * rows
    for B, hw, C, sr in SR_GEOMETRIES:
        M, K = B * (hw // sr) ** 2, sr * sr * C
        tile, slices = tmb.sr_conv_plan(M, C, K, dtype)
        cuts = tmb.sr_conv_slices(K, slices)
        assert cuts[0][0] == 0 and cuts[-1][1] == K and tmb.sr_conv_smem_bytes(tile, dtype) \
            <= tmb.SMEM_LIMIT


@pytest.mark.parametrize("tile", tmb.LINEAR_TILES)
@pytest.mark.parametrize("per", [1, 3])
@pytest.mark.parametrize("ln,res", [(True, False), (False, True)])
def test_linear_with_a_plan_on_cpu_is_the_plain_version(tile, per, ln, res):
    """On CPU tensors `linear(..., plan=)` runs `linear_reference` whatever the plan (a bf16
    tile walking `per` M tiles; for f32 the f32 tile of the same place, `per` persistent
    blocks), launches nothing, and is held to the JAX kernel's `_ln` and `_mm` (f32
    operands: the same math summed in another order, 2e-5, this file's per-block bound)."""
    rng = np.random.default_rng(per + 7 * ln)
    M, Nout, K = 37, 96, 64
    a = rng.standard_normal((M, K)).astype(np.float32) * 2 + 0.5
    w = (rng.standard_normal((Nout, K)) * 0.1).astype(np.float32)
    b, lw, lb = (rng.standard_normal(n).astype(np.float32) for n in (Nout, K, K))
    r = rng.standard_normal((M, Nout)).astype(np.float32)
    at = torch.from_numpy(a)
    kw = dict(residual=torch.from_numpy(r) if res else None)
    if ln:
        kw.update(stats=tmb.ln_stats_reference(at), ln_w=torch.from_numpy(lw),
                  ln_b=torch.from_numpy(lb))
    tmb.reset_launches()
    f32_tile = tmb.LINEAR_TILES_F32[tmb.LINEAR_TILES.index(tile) % len(tmb.LINEAR_TILES_F32)]
    for dtype, plan in ((torch.bfloat16, (tile, per)), (torch.float32, (f32_tile, per))):
        got = tmb.linear(at, torch.from_numpy(w), torch.from_numpy(b), plan=plan,
                         dtype=dtype, **kw)
        assert torch.equal(got, tmb.linear_reference(at, torch.from_numpy(w),
                                                     torch.from_numpy(b), dtype=dtype, **kw))
    assert sum(tmb.LAUNCHES.values()) == 0
    x = jmb._ln(jnp.asarray(a), jnp.asarray(lw), jnp.asarray(lb)) if ln else jnp.asarray(a)
    want = jmb._mm(x, jnp.asarray(w).T, jnp.float32) + jnp.asarray(b)
    if res:
        want = want + jnp.asarray(r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


# `dwconv_gelu`'s plan at every launch geometry of the headline forward (batch 8 at
# 512) and of the CAM forwards (batch 16 at 320, 160, 480 and 0.3 of 320: grids
# down to 3 x 3), and at the edges of the kernel's runs: grids of 1 to 15 rows and
# columns, hid 4 to 2048
_DW_STAGES = [(64, 4), (128, 8), (320, 16), (512, 16)]   # C, pixels a token a side


def _dwconv_geometries():
    geos = {(B, side // f, side // f, 4 * C)
            for B, side in [(8, 512)] + [(16, s) for s in (320, 160, 480, 96, 48, 144)]
            for C, f in _DW_STAGES}
    geos |= {(16, H, W, hid) for H, W in ((1, 1), (1, 15), (2, 3), (5, 2), (15, 15), (3, 5))
             for hid in (4, 32, 96, 2048)}
    return sorted(geos)


DWCONV_GEOMETRIES = _dwconv_geometries()


@pytest.mark.parametrize("B,H,W,hid", DWCONV_GEOMETRIES)
def test_dwconv_plan_covers_every_token_and_channel_once(B, H, W, hid):
    """The plan is a function of (B, H, W, hid) alone and names a run of columns the
    kernel is instantiated for. Laid out as the kernel lays out its grid (threads of
    a block along channel groups, then column runs; blocks along row runs and
    images), it writes every column and channel group of a row exactly once and every
    row exactly once, within the grid's limits."""
    cols, rows = tmb.dwconv_plan(B, H, W, hid)
    assert (cols, rows) == tmb.dwconv_plan(B, H, W, hid)
    assert tmb.check_dwconv_plan((cols, rows)) == (cols, rows)
    assert cols in tmb.DWCONV_COLUMNS and cols <= W and rows == tmb.DWCONV_ROWS
    G, runs = hid // 4, -(-W // cols)
    t = np.arange(-(-G * runs // tmb.DWCONV_THREADS) * tmb.DWCONV_THREADS)
    t = t[t < G * runs]
    xr, c4 = t // G, t % G
    cover = np.zeros((W, G), np.int64)
    for j in range(cols):
        x = xr * cols + j
        np.add.at(cover, (x[x < W], c4[x < W]), 1)
    assert (cover == 1).all()
    ycover = np.zeros(H, np.int64)
    for by in range(-(-H // rows)):
        ycover[by * rows: by * rows + rows] += 1
    assert (ycover == 1).all() and -(-H // rows) <= 65535 and B <= 65535


def test_dwconv_gelu_refuses_what_the_kernel_does_not_take_on_the_cpu_too():
    """hid % 4 != 0 (a thread owns a float4 of channels) and a plan the kernel does not
    take raise on CPU tensors as on the card."""
    g = torch.Generator().manual_seed(0)
    f, w, b = torch.randn(2, 12, 36, generator=g), torch.randn(36, 1, 3, 3), torch.randn(36)
    with pytest.raises(ValueError, match="multiple of 4"):
        tmb.dwconv_gelu(f[..., :34].contiguous(), w[:34], b[:34], H=3, W=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tmb.dwconv_plan(2, 3, 4, 34)
    for plan in ((3, 4), (4, 0), (2,), "ab"):
        with pytest.raises(ValueError, match="plan"):
            tmb.dwconv_gelu(f, w, b, H=3, W=4, plan=plan)
    assert torch.equal(tmb.dwconv_gelu(f, w, b, H=3, W=4, plan=(4, 1)),
                       tmb.dwconv_gelu_reference(f, w, b, H=3, W=4))


def _jax_dwconv_gelu(f, w, b, H, W):
    """The TPU kernel's depthwise conv and GELU (`_block_math`'s nine shifted
    multiply-adds, then `_erf`) on one image of (H * W, hid) f32."""
    hid = f.shape[-1]
    fi = jnp.asarray(f).reshape(H, W, hid)
    dw = jnp.asarray(w).reshape(hid, 3, 3).transpose(1, 2, 0)
    acc = jnp.zeros((H, W, hid), jnp.float32)
    for ky in range(3):
        for kx in range(3):
            dy, dx = ky - 1, kx - 1
            src = fi[max(0, dy): H + min(0, dy), max(0, dx): W + min(0, dx)]
            pad = ((max(0, -dy), max(0, dy)), (max(0, -dx), max(0, dx)), (0, 0))
            acc = acc + jnp.pad(src * dw[ky, kx], pad)
    v = (acc + jnp.asarray(b)).reshape(H * W, hid)
    return np.asarray(0.5 * v * (1.0 + jmb._erf(v * (2.0 ** -0.5))))


@pytest.mark.parametrize("cols", tmb.DWCONV_COLUMNS)
@pytest.mark.parametrize("rows", [1, 3, 16])
def test_dwconv_gelu_with_a_plan_on_cpu_is_the_plain_version(cols, rows):
    """On CPU tensors `dwconv_gelu(..., plan=)` runs `dwconv_gelu_reference` whatever
    the plan, launches nothing, and is held to the TPU kernel's math (the same f32
    multiply-adds in the same order; only `exp` may differ in the last bit)."""
    rng = np.random.default_rng(10 * cols + rows)
    B, H, W, hid = 2, 5, 7, 8
    f = rng.standard_normal((B, H * W, hid)).astype(np.float32)
    w = (rng.standard_normal((hid, 1, 3, 3)) * 0.3).astype(np.float32)
    b = rng.standard_normal(hid).astype(np.float32)
    ft, wt, bt = (torch.from_numpy(a) for a in (f, w, b))
    tmb.reset_launches()
    got = tmb.dwconv_gelu(ft, wt, bt, H=H, W=W, plan=(cols, rows))
    assert torch.equal(got, tmb.dwconv_gelu_reference(ft, wt, bt, H=H, W=W))
    assert sum(tmb.LAUNCHES.values()) == 0
    for i in range(B):
        np.testing.assert_allclose(got[i].numpy(), _jax_dwconv_gelu(f[i], w, b, H, W),
                                   atol=2e-6, rtol=0)


# --------------------------------- linear with f32 operands: the 3xTF32 wgmma kernel
def _f32_cost(M, Nout, K, tile):
    """`_linear_plan_f32`'s model of one tile's SM cycles, times the waves of tiles."""
    bm, bn = tile
    tiles = -(-M // bm) * -(-Nout // bn)
    return -(-tiles // tmb.LINEAR_SMS) * (K * max(3 * bm * bn / 1024, (bm + bn) * 4 / 24)
                                          + bm * bn / 3)


@pytest.mark.parametrize("M,Nout,K", LINEAR_GEOMETRIES)
def test_linear_plan_f32_picks_a_tile_of_the_wgmma_kernel(M, Nout, K):
    """With f32 operands the plan is (tile, blocks): a tile of LINEAR_TILES_F32, the one
    its model of SM cycles rates fastest (the wider on a tie), and one persistent block a
    tile up to one an SM; a function of (M, Nout, K) alone, and the bf16 plan unchanged."""
    tile, blocks = tmb.linear_plan(M, Nout, K, torch.float32)
    assert (tile, blocks) == tmb.linear_plan(M, Nout, K, torch.float32)
    assert tmb.check_linear_plan((tile, blocks), torch.float32) == \
        (tmb.LINEAR_TILES_F32.index(tile), blocks)
    costs = [_f32_cost(M, Nout, K, t) for t in tmb.LINEAR_TILES_F32]
    assert _f32_cost(M, Nout, K, tile) == min(costs)
    out_tiles = -(-M // tile[0]) * -(-Nout // tile[1])
    assert blocks == min(out_tiles, tmb.LINEAR_SMS)
    assert tmb.linear_plan(M, Nout, K) == tmb.linear_plan(M, Nout, K, torch.bfloat16)
    assert tmb.linear_plan(M, Nout, K)[0] in tmb.LINEAR_TILES


@pytest.mark.parametrize("dtype,plan", [
    (torch.float32, ((64, 128), 1)), (torch.float32, ((128, 256), 1)),
    (torch.float32, ((128, 64), 0)), (torch.float32, ((128, 64),)),
    (torch.bfloat16, ((128, 64), 1)), (torch.bfloat16, ((64, 96), 1)),
    (torch.bfloat16, ((64, 64), 0)), (torch.bfloat16, "ab"), (torch.float32, 7)])
def test_linear_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too(dtype, plan):
    """A tile the kernel of that operand type lacks (the f32 kernel's tiles are not the
    bf16 kernel's), no block or M tile, and what is no (tile, count) pair raise on CPU
    tensors as on the card, before anything runs."""
    a, w, b = torch.zeros(8, 64), torch.zeros(96, 64), torch.zeros(96)
    with pytest.raises(ValueError, match="plan"):
        tmb.linear(a, w, b, dtype=dtype, plan=plan)
    assert tmb.linear(a, w, b, dtype=dtype, plan=tmb.linear_plan(8, 96, 64, dtype)).shape == (8, 96)


@pytest.mark.parametrize("M", [1, 63, 65, 127, 129])
@pytest.mark.parametrize("ln,res", [(False, False), (True, True)])
def test_linear_reference_f32_matches_jax_at_the_tile_edges(M, ln, res):
    """The plain `linear` that the card tests hold the f32 kernel to, at the row counts
    around its 128-row tiles (and the bf16 kernel's 64), Nout that no column tile
    divides: the JAX kernel's `_ln` and `_mm` in f32 to 2e-5."""
    rng = np.random.default_rng(M + 2 * ln)
    K, Nout = 96, 200
    a = rng.standard_normal((M, K)).astype(np.float32) * 2 + 0.5
    w = (rng.standard_normal((Nout, K)) * 0.1).astype(np.float32)
    b, lw, lb = (rng.standard_normal(n).astype(np.float32) for n in (Nout, K, K))
    r = rng.standard_normal((M, Nout)).astype(np.float32)
    at = torch.from_numpy(a)
    kw = dict(residual=torch.from_numpy(r) if res else None)
    if ln:
        kw.update(stats=tmb.ln_stats_reference(at), ln_w=torch.from_numpy(lw),
                  ln_b=torch.from_numpy(lb))
    got = tmb.linear_reference(at, torch.from_numpy(w), torch.from_numpy(b),
                               dtype=torch.float32, **kw)
    x = jmb._ln(jnp.asarray(a), jnp.asarray(lw), jnp.asarray(lb)) if ln else jnp.asarray(a)
    want = jmb._mm(x, jnp.asarray(w).T, jnp.float32) + jnp.asarray(b)
    if res:
        want = want + jnp.asarray(r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


# ------------------------------------------------ attention's plan with f32 operands
# (C, nh, sr) of the four MiT stages, and the token grids of a forward at side x side
# (side / 4, / 8, / 16, / 16: stride 1 at stage 4, so that stage 4 exports N = Nk)
_ATTN_ARCHS = {"mit_b1": [(64, 1, 8), (128, 2, 4), (320, 5, 2), (512, 8, 1)],
               "mit_b0": [(32, 1, 8), (64, 2, 4), (160, 5, 2), (256, 8, 1)]}


def _attention_geometries():
    """(B, N, Nk, C, nh) of every `attention` launch of the headline forward (8 x 512²)
    and of the WSSS command lines' f32 CAM twins (16 images: a batch and its flips, at
    320² and scales 0.5 and 1.5), for MiT-B1 and MiT-B0 (head width 32 at stage 1)."""
    geos = []
    for stages in _ATTN_ARCHS.values():
        for B, side in ((8, 512), (16, 320), (16, 160), (16, 480)):
            t = side // 4
            for hw, (C, nh, sr) in zip((t, t // 2, t // 4, t // 4), stages):
                geos.append((B, hw * hw, (hw // sr) ** 2, C, nh))
    return sorted(set(geos))


ATTENTION_GEOMETRIES = _attention_geometries()


@pytest.mark.parametrize("B,N,Nk,C,nh", ATTENTION_GEOMETRIES)
def test_attention_plan_f32_covers_every_query_once_and_fits(B, N, Nk, C, nh):
    """With f32 operands the plan is (queries, blocks): 128 queries a block (two consumer
    warpgroups) unless that leaves more than half the SMs without a unit, persistent
    blocks one a unit up to one an SM; a function of the shapes alone. The kernel's walk
    (unit u = block, block + blocks, ...; a unit `queries` queries of one (image, head))
    takes every query of every head once, and the block's shared memory fits. The
    geometries hold the CLIs' Nk 25, 100, 225 (no multiple of the key tile) and exporting
    N = Nk = 100, 400, 900."""
    f32 = torch.float32
    queries, blocks = tmb.attention_plan(B, N, Nk, C, nh, f32)
    assert (queries, blocks) == tmb.attention_plan(B, N, Nk, C, nh, f32)
    assert tmb.check_attention_plan((queries, blocks), B, N, Nk, C, nh, f32) == (queries, blocks)
    units = tmb.attention_units(B, N, nh, queries)
    assert queries == (128 if 2 * tmb.attention_units(B, N, nh, 128) > tmb.ATTN_SMS else 64)
    assert blocks == min(units, tmb.ATTN_SMS)
    qtiles = -(-N // queries)
    seen = np.zeros((B * nh, N), np.int32)
    for block in range(blocks):
        for u in range(block, units, blocks):
            bh, qt = divmod(u, qtiles)
            seen[bh, qt * queries: (qt + 1) * queries] += 1
    assert (seen == 1).all()
    hd = C // nh
    assert tmb.attention_stages(queries, hd) >= 2
    assert tmb.attention_smem_bytes((queries, blocks), hd, f32) <= tmb.SMEM_LIMIT
    nkp = -(-Nk // tmb.ATTN_WG_KEYS) * tmb.ATTN_WG_KEYS
    assert tmb.attention_workspace_elems(B, Nk, C, f32) == B * nh * hd * (Nk + nkp)


def test_attention_bf16_forms_are_unchanged():
    """The bf16 kernel keeps its forms: one pass up to 256 keys (K and V of 64, 128 or
    256 keys in shared memory), two passes over tiles of 64 keys beyond; it takes no plan
    but its own, and its workspace is k and v in bf16."""
    bf16 = torch.bfloat16
    assert tmb.ATTN_ONE_PASS_KEYS == 256 and tmb.ATTN_STREAM_KEYS == 64
    for Nk, want in ((1, ("one_pass", 64)), (64, ("one_pass", 64)), (65, ("one_pass", 128)),
                     (128, ("one_pass", 128)), (129, ("one_pass", 256)),
                     (256, ("one_pass", 256)), (257, ("streaming", 64)),
                     (1024, ("streaming", 64))):
        plan = tmb.attention_plan(2, 100, Nk, 128, 2, bf16)
        assert plan == want == tmb.check_attention_plan(want, 2, 100, Nk, 128, 2, bf16)
        for hd in (32, 64):
            assert tmb.attention_smem_bytes(plan, hd, bf16) <= 72 * 1024 + 4096
    assert tmb.attention_workspace_elems(2, 100, 128, bf16) == 2 * 100 * 256


@pytest.mark.parametrize("plan", [(64, 1), (128, 3), (128, 132), (64, 500)])
@pytest.mark.parametrize("export", [False, True])
def test_attention_with_a_plan_on_cpu_is_the_plain_version(plan, export):
    """`attention(..., dtype=f32, plan=)` on CPU tensors runs `attention_reference`
    and launches nothing, whatever plan it is given."""
    g = torch.Generator().manual_seed(len(plan) + plan[1])
    q, kv = torch.randn(2, 65, 64, generator=g), torch.randn(2, 25, 128, generator=g)
    before = dict(tmb.LAUNCHES)
    got = tmb.attention(q, kv, nh=2, dtype=torch.float32, export=export, plan=plan)
    want = tmb.attention_reference(q, kv, nh=2, dtype=torch.float32, export=export)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (not export) and (not export or torch.equal(got[1], want[1]))
    assert tmb.LAUNCHES == before


@pytest.mark.parametrize("dtype,plan", [
    (torch.float32, (32, 1)), (torch.float32, (128, 0)), (torch.float32, (128,)),
    (torch.float32, "ab"), (torch.float32, 7), (torch.float32, ("one_pass", 64)),
    (torch.bfloat16, (128, 1)), (torch.bfloat16, ("streaming", 64)),
    (torch.bfloat16, ("one_pass", 256))])
def test_attention_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too(dtype, plan):
    """A query count the f32 kernel lacks, no block, what is no (queries, blocks) pair,
    and for bf16 any plan but its own form (64 keys: ("one_pass", 64)) raise on CPU
    tensors as on the card, before anything runs."""
    q, kv = torch.zeros(1, 9, 64), torch.zeros(1, 40, 128)
    with pytest.raises(ValueError, match="plan"):
        tmb.attention(q, kv, nh=1, dtype=dtype, plan=plan)
    own = tmb.attention_plan(1, 9, 40, 64, 1, dtype)
    assert tmb.attention(q, kv, nh=1, dtype=dtype, plan=own)[0].shape == (1, 9, 64)


@pytest.mark.parametrize("N,Nk", [(400, 100), (100, 100), (400, 400)])
@pytest.mark.parametrize("nh", [1, 2])
def test_attention_reference_f32_matches_jax_block_math_at_the_cli_geometries(N, Nk, nh):
    """The plain `attention` that the card tests hold the f32 kernel to, exporting, at the
    WSSS command lines' (N, Nk) at 320² (stage 1-3 Nk = 100 against N = 400 and 100, stage
    4 N = Nk = 400), head widths 64 and 32: the JAX kernel's `_block_math` with q and kv
    handed in (the PRE_SR form: h = q through an identity q kernel, xs with kv = xs W +
    b), the projection an identity, x and fc2 zero, so that its output is the attention
    output; f32 on both sides to this file's 2e-5 (logits 2e-4)."""
    rng = np.random.default_rng(N + Nk + nh)
    C, hid = 64, 64
    side = int(round(N ** 0.5))
    h = rng.standard_normal((N, C)).astype(np.float32)
    xs = rng.standard_normal((Nk, C)).astype(np.float32)
    w_kv = (rng.standard_normal((C, 2 * C)) * 0.3).astype(np.float32)
    b_kv = (rng.standard_normal(2 * C) * 0.1).astype(np.float32)
    f32 = jnp.float32
    p = {"q_kernel": jnp.eye(C, dtype=f32), "q_bias": jnp.zeros(C, f32),
         "kv_kernel": jnp.asarray(w_kv), "kv_bias": jnp.asarray(b_kv),
         "proj_kernel": jnp.eye(C, dtype=f32), "proj_bias": jnp.zeros(C, f32),
         "ln2_scale": jnp.ones(C, f32), "ln2_bias": jnp.zeros(C, f32),
         "fc1_kernel": jnp.asarray(rng.standard_normal((C, hid)).astype(np.float32) * 0.1),
         "fc1_bias": jnp.zeros(hid, f32), "dw_kernel": jnp.ones((3, 3, hid), f32),
         "dw_bias": jnp.zeros(hid, f32), "fc2_kernel": jnp.zeros((hid, C), f32),
         "fc2_bias": jnp.zeros(C, f32)}
    want, want_logits = jmb._block_math(jnp.zeros((N, C), f32), p, H=side, W=side, sr=1,
                                         nh=nh, dtype=f32, export=True, h=jnp.asarray(h),
                                         xs=jnp.asarray(xs))
    kv = np.array(jmb._mm(jnp.asarray(xs), p["kv_kernel"], f32) + p["kv_bias"])
    out, logits = tmb.attention_reference(torch.from_numpy(h)[None], torch.from_numpy(kv)[None],
                                          nh=nh, dtype=torch.float32, export=True)
    assert logits.shape == (1, nh, N, Nk)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want), atol=F32_ATOL)
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(want_logits), atol=LOGIT_ATOL)
