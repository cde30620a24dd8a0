"""Kernel K5 (the RSSFormer MlpDWBN feed-forward block) of the PyTorch port
against the JAX package.

The same numpy-seeded tokens and weights go through the JAX
`fused_mlp_dwbn_reference` and `fused_mlp_dwbn_pallas` (interpret mode on the CPU,
as `tests/test_pallas_mlp_dwbn.py:64-95` runs them) and through the port's
`fused_mlp_dwbn_reference` / `fused_mlp_dwbn` (which, on a CPU tensor, is the
plain version). Planes include one smaller than the dilations (every d12 tap but
the centre reads padding) and non-square ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.ops.pallas import mlp_dwbn as jm
from representationlearning_tpu_torch.ops import mlp_dwbn as tm

torch.set_num_threads(2)

# f32: both sides do the same f32 math; the 19 tap products are summed in the
# same order, the sums inside a product (K <= 64) in XLA's or torch's order
F32_ATOL = 2e-5
GEOMETRIES = [(12, 9, 8, 32, 8), (5, 7, 16, 64, 16), (16, 16, 8, 32, 8), (30, 13, 4, 24, 12)]


def jax_params(rng, cin, hid, cout):
    def r(*s, sc=1.0, sh=0.0):
        return (rng.standard_normal(s) * sc + sh).astype(np.float32)

    return {
        "fc1_kernel": r(cin, hid, sc=0.2), "fc1_bias": r(hid, sc=0.1),
        "bn1_scale": r(hid, sc=0.2, sh=1.0), "bn1_shift": r(hid, sc=0.1),
        "dw1_kernel": r(hid, hid, sc=0.1), "dw6_kernel": r(3, 3, hid, hid, sc=0.05),
        "dw12_kernel": r(3, 3, hid, hid, sc=0.05), "dw_bias": r(hid, sc=0.1),
        "bn2_scale": r(hid, sc=0.2, sh=1.0), "bn2_shift": r(hid, sc=0.1),
        "fc2_kernel": r(hid, cout, sc=0.2), "fc2_bias": r(cout, sc=0.1),
        "bn3_scale": r(cout, sc=0.2, sh=1.0), "bn3_shift": r(cout, sc=0.1),
    }


def torch_params(p: dict) -> dict:
    """The JAX kernel's flat param dict -> the port's, in torch conv layouts."""
    out = {}
    for k, v in p.items():
        if k in ("fc1_kernel", "dw1_kernel", "fc2_kernel"):
            v = v.T[:, :, None, None]                       # (in, out) -> (out, in, 1, 1)
        elif k.endswith("_kernel"):
            v = v.transpose(3, 2, 0, 1)                     # HWIO -> OIHW
        out[k.replace("_kernel", "_weight")] = torch.from_numpy(np.array(v))
    return out


def _setup(H, W, cin, hid, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H * W, cin)).astype(np.float32)
    p = jax_params(rng, cin, hid, cout)
    return x, {k: jnp.asarray(v) for k, v in p.items()}, torch_params(p)


@pytest.mark.parametrize("H,W,cin,hid,cout", GEOMETRIES)
def test_fused_mlp_dwbn_reference_matches_jax(H, W, cin, hid, cout):
    x, jp, tp = _setup(H, W, cin, hid, cout, seed=H * W)
    want = np.asarray(jm.fused_mlp_dwbn_reference(jnp.asarray(x), jp, H=H, W=W))
    wantk = np.asarray(jm.fused_mlp_dwbn_pallas(jnp.asarray(x), jp, H=H, W=W, interpret=True))
    got = tm.fused_mlp_dwbn_reference(torch.from_numpy(x), tp, H=H, W=W)
    assert got.shape == (2, H * W, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), wantk, atol=F32_ATOL)
    # on a CPU tensor the dispatcher is the plain version, bit for bit
    tm.reset_launches()
    assert torch.equal(tm.fused_mlp_dwbn(torch.from_numpy(x), tp, H=H, W=W), got)
    assert sum(tm.LAUNCHES.values()) == 0


@pytest.mark.parametrize("H,W,cin,hid,cout", GEOMETRIES[:2])
def test_fused_mlp_dwbn_bf16_matches_jax_bf16(H, W, cin, hid, cout):
    """bf16 operands, f32 sums. Both sides round the same f32 values to bf16
    before each product; where the two frameworks' f32 sums differ in the last
    bits a hidden value rounds to the neighbouring bf16 (2^-8 relative) and moves
    the output by that times a weight: 2e-3 of the largest magnitude bounds a
    few such flips."""
    x, jp, tp = _setup(H, W, cin, hid, cout, seed=3)
    want = np.asarray(jm.fused_mlp_dwbn_reference(jnp.asarray(x), jp, H=H, W=W,
                                                  dtype=jnp.bfloat16))
    got = tm.fused_mlp_dwbn_reference(torch.from_numpy(x), tp, H=H, W=W,
                                      dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())


def test_pieces_compose_to_the_whole():
    """mlp_fc1 then mlp_taps, the two kernels' plain versions, are the block."""
    H, W, cin, hid, cout = 9, 11, 16, 32, 16
    x, _, tp = _setup(H, W, cin, hid, cout, seed=5)
    xt = torch.from_numpy(x)
    for dtype in (torch.float32, torch.bfloat16):
        h = tm.mlp_fc1_reference(xt, tp["fc1_weight"].reshape(hid, cin).to(dtype),
                                 tp["fc1_bias"], tp["bn1_scale"], tp["bn1_shift"], dtype=dtype)
        assert h.dtype == dtype and h.shape == (2, H * W, hid)
        out = tm.mlp_taps_reference(
            h, tm.tap_weights(tp).to(dtype), tp["dw_bias"], tp["bn2_scale"], tp["bn2_shift"],
            tp["fc2_weight"].reshape(cout, hid).to(dtype), tp["fc2_bias"], tp["bn3_scale"],
            tp["bn3_shift"], H=H, W=W, dtype=dtype)
        assert torch.equal(out, tm.fused_mlp_dwbn_reference(xt, tp, H=H, W=W, dtype=dtype))


def test_taps_match_torch_dilated_convs():
    """The 19 shifted products against F.conv2d with dilation 6 and 12."""
    import torch.nn.functional as F

    H, W, hid = 14, 10, 16
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, H * W, hid, generator=g)
    p = {"dw1_weight": torch.randn(hid, hid, 1, 1, generator=g),
         "dw6_weight": torch.randn(hid, hid, 3, 3, generator=g),
         "dw12_weight": torch.randn(hid, hid, 3, 3, generator=g)}
    assert tm.tap_offsets()[:3] == [(0, 0), (-6, -6), (-6, 0)] and len(tm.tap_offsets()) == 19
    one, zero = torch.ones(hid), torch.zeros(hid)
    eye = torch.eye(hid)
    got = tm.mlp_taps_reference(h, tm.tap_weights(p), zero, one, zero, eye, zero, one, zero,
                                H=H, W=W, dtype=torch.float32)
    m = h.transpose(1, 2).reshape(2, hid, H, W)
    conv = F.conv2d(m, p["dw1_weight"]) + F.conv2d(m, p["dw6_weight"], padding=6, dilation=6) \
        + F.conv2d(m, p["dw12_weight"], padding=12, dilation=12)
    want = F.gelu(F.gelu(conv)).flatten(2).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_fold_bn_affine_matches_jax_and_batch_norm():
    rng = np.random.default_rng(1)
    w, b, mean = (rng.standard_normal(12).astype(np.float32) for _ in range(3))
    var = (np.abs(rng.standard_normal(12)) + 0.5).astype(np.float32)
    g, s = tm.fold_bn_affine(*(torch.from_numpy(a) for a in (w, b, mean, var)))
    jg, js = jm.fold_bn_affine(*(jnp.asarray(a) for a in (w, b, mean, var)))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    x = torch.randn(3, 12, 4, 4)
    want = torch.nn.functional.batch_norm(x, *(torch.from_numpy(a) for a in (mean, var, w, b)),
                                          training=False, eps=1e-5)
    np.testing.assert_allclose((x * g[:, None, None] + s[:, None, None]).numpy(),
                               want.numpy(), atol=1e-5)


# `mlp_fc1`'s plan at the RSSFormer predict (4 x 128 x 128 tokens of hrnetv2_w32's 32
# features), the TTA's batch of 2, and the kernel's edges: token counts of one row, of
# a tile less or more one and no multiple of any step, every width up to 256
FC1_GEOMETRIES = sorted({(4 * 128 * 128, 32), (2 * 128 * 128, 32)}
                        | {(M, cin) for M in (1, 15, 17, 1000, 8517)
                           for cin in (16, 32, 48, 64, 128, 192, 256)})


@pytest.mark.parametrize("M,cin", FC1_GEOMETRIES)
def test_fc1_plan_covers_every_token_once(M, cin):
    """The plan is a function of (M, cin) alone and fits the kernel's shared memory.
    Laid out as the kernel walks it (block b, step i, warp w take the 16-row tile
    (b per + i) warps + w), it covers every tile of rows exactly once, and all 128
    features of each; the grid is one wave of the blocks an SM holds, with the fewest
    steps a block that allow it."""
    warps, per = tm.fc1_plan(M, cin)
    assert (warps, per) == tm.fc1_plan(M, cin)
    assert tm.check_fc1_plan((warps, per), cin) == (warps, per)
    assert 1 <= warps <= tm.FC1_MAX_WARPS and tm.fc1_fits(cin, warps)
    assert tm.fc1_smem_bytes(cin, warps) <= tm.SMEM_LIMIT
    tiles = -(-M // tm.FC1_ROWS)
    steps = -(-tiles // warps)
    blocks = -(-steps // per)
    b, i, w = np.meshgrid(np.arange(blocks), np.arange(per), np.arange(warps), indexing="ij")
    tile = ((b * per + i) * warps + w).ravel()
    assert (np.bincount(tile[tile < tiles], minlength=tiles) == 1).all()
    assert tiles * tm.FC1_ROWS >= M > (tiles - 1) * tm.FC1_ROWS
    resident = tm.fc1_blocks_per_sm(cin, warps) * tm.FC1_SMS
    assert blocks <= resident and (per == 1 or -(-steps // (per - 1)) > resident)


# the f32 kernel's plan (tile of hidden features, blocks) beside each bf16 (warps, per)
F32_PLAN_OF = {None: None, (1, 1): (128, 1), (2, 3): (32, 3), (4, 2): (128, 2), (8, 1): (32, 132)}


@pytest.mark.parametrize("plan", [None, (1, 1), (2, 3), (4, 2), (8, 1)])
def test_fc1_with_a_plan_on_cpu_is_the_plain_version(plan):
    """On CPU tensors `mlp_fc1(..., plan=)` runs `mlp_fc1_reference` whatever the plan
    (bf16 (warps, per), f32 (tile, blocks)), launches nothing, and is held to the TPU
    kernel's fc1 + bn1 + GELU (`_mlp_math`'s first lines): f32 operands, the same math
    summed in another order."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, 32)).astype(np.float32)
    w1 = (rng.standard_normal((128, 32)) * 0.2).astype(np.float32)
    b1, t1 = (rng.standard_normal(128).astype(np.float32) * 0.1 for _ in range(2))
    s1 = (rng.standard_normal(128) * 0.2 + 1.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, w1, b1, s1, t1)]
    tm.reset_launches()
    for dtype, pl in ((torch.bfloat16, plan), (torch.float32, F32_PLAN_OF[plan])):
        got = tm.mlp_fc1(*args, dtype=dtype, plan=pl)
        assert torch.equal(got, tm.mlp_fc1_reference(*args, dtype=dtype))
    assert sum(tm.LAUNCHES.values()) == 0
    want = jm._gelu((jm._mm(jnp.asarray(x), jnp.asarray(w1.T), jnp.float32) + b1) * s1 + t1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


def test_fc1_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too():
    """Warps outside 1..8, no step a block, a ring that no shared memory holds (8 warps
    at cin 256), and what is no pair raise on CPU tensors as on the card."""
    x, w1 = torch.zeros(1, 16, 256), torch.zeros(128, 256)
    v = torch.zeros(128)
    for plan in ((0, 1), (9, 1), (4, 0), (8, 1), (4,), "ab"):
        with pytest.raises(ValueError, match="plan"):
            tm.mlp_fc1(x, w1, v, v, v, plan=plan)
    assert tm.mlp_fc1(x, w1, v, v, v, plan=(4, 1)).shape == (1, 16, 128)


# `mlp_taps`' plan at the RSSFormer predict (4 x 128 x 128 tokens), the TTA's planes at
# batch 2 (`infer/tta.py::default_tta_config`, scales 0.5-1.75 of 128), a plane below both
# dilations, a non-square one whose 900 tokens no tile divides, one token; every width of
# fc2's output
TAPS_GEOMETRIES = sorted({(4, 128, 128, 32)}
                         | {(2, s, s, 32) for s in (64, 96, 128, 160, 192, 224)}
                         | {(B, H, W, cout) for B, H, W in ((2, 7, 9), (1, 20, 45), (1, 1, 1))
                            for cout in (16, 32, 128)})


@pytest.mark.parametrize("B,H,W,cout", TAPS_GEOMETRIES)
def test_taps_plan_covers_every_token_once(B, H, W, cout):
    """The plan is a function of the shapes alone and fits the kernel's shared memory.
    Laid out as the kernel walks it (block b takes the tiles b, b + blocks, ...), it
    covers every tile of tokens exactly once and every token in exactly one tile; the
    grid is at most one wave of the blocks the card holds, and no block is idle."""
    tile, blocks = tm.taps_plan(B, H, W, cout)
    assert (tile, blocks) == tm.taps_plan(B, H, W, cout)
    assert tm.check_taps_plan((tile, blocks)) == (tile, blocks)
    assert tm.taps_smem_bytes(tile) <= tm.SMEM_LIMIT and tm.taps_stages(tile) >= 3
    M = B * H * W
    tiles = -(-M // tile)
    walk = np.concatenate([np.arange(b, tiles, blocks) for b in range(blocks)])
    assert (np.bincount(walk, minlength=tiles) == 1).all()
    tokens = (walk[:, None] * tile + np.arange(tile)[None, :]).ravel()
    assert (np.bincount(tokens[tokens < M], minlength=M) == 1).all()
    assert blocks <= tm.taps_blocks_per_sm(tile) * tm.TAPS_SMS and blocks <= tiles
    # the larger tile wherever it gives at least half the SMs a tile
    assert tile == (256 if -(-M // 256) >= tm.TAPS_SMS // 2 else 128)


@pytest.mark.parametrize("plan", [None, (128, 1), (128, 5), (256, 2), (256, 132)])
def test_taps_with_a_plan_on_cpu_is_the_plain_version(plan):
    """On CPU tensors `mlp_taps(..., plan=)` runs `mlp_taps_reference` whatever the plan
    (f32 takes the plan's blocks on its one tile of 128 tokens) and launches nothing;
    after the port's plain fc1 it is the TPU kernel's `_mlp_math` (the JAX reference and
    the Pallas kernel in interpret mode), f32 operands."""
    H, W, cin, hid, cout = 13, 15, 16, 128, 16
    x, jp, tp = _setup(H, W, cin, hid, cout, seed=11)
    h = tm.mlp_fc1_reference(torch.from_numpy(x), tp["fc1_weight"].reshape(hid, cin),
                             tp["fc1_bias"], tp["bn1_scale"], tp["bn1_shift"],
                             dtype=torch.float32)
    rest = (tm.tap_weights(tp), tp["dw_bias"], tp["bn2_scale"], tp["bn2_shift"],
            tp["fc2_weight"].reshape(cout, hid), tp["fc2_bias"], tp["bn3_scale"],
            tp["bn3_shift"])
    tm.reset_launches()
    f32_plan = None if plan is None else (tm.TAPS_TILE_F32, plan[1])
    for dtype, pl in ((torch.bfloat16, plan), (torch.float32, f32_plan)):
        got = tm.mlp_taps(h, *rest, H=H, W=W, dtype=dtype, plan=pl)
        assert torch.equal(got, tm.mlp_taps_reference(h, *rest, H=H, W=W, dtype=dtype))
    assert sum(tm.LAUNCHES.values()) == 0
    want = np.asarray(jm.fused_mlp_dwbn_reference(jnp.asarray(x), jp, H=H, W=W))
    wantk = np.asarray(jm.fused_mlp_dwbn_pallas(jnp.asarray(x), jp, H=H, W=W, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), wantk, atol=F32_ATOL, rtol=0)


def test_taps_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too():
    """Tiles other than 128 and 256, no block, and what is no pair raise on CPU tensors
    as on the card."""
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 12, 128, generator=g), torch.randn(19, 128, 128, generator=g),
            *(torch.randn(128, generator=g) for _ in range(3)),
            torch.randn(16, 128, generator=g), *(torch.randn(16, generator=g) for _ in range(3)))
    for plan in ((64, 1), (512, 1), (192, 1), (128, 0), (256, -1), (256, 3, 1), (128,),
                 "ab", 7):
        with pytest.raises(ValueError, match="plan"):
            tm.mlp_taps(*args, H=3, W=4, plan=plan)
    assert tm.mlp_taps(*args, H=3, W=4, plan=(128, 1)).shape == (1, 12, 16)


@pytest.mark.parametrize("tile", [128, 256])
def test_taps_blocks_per_sm_estimate_fits_the_sm(tile):
    """The estimate of blocks an SM holds never asks for more shared memory than an SM
    has (each block also takes 1 KB of it) or more registers than 65,536: eight warps a
    block at up to 128 registers a thread for two blocks, up to 255 for one."""
    assert tm.taps_smem_bytes(tile) <= tm.SMEM_LIMIT
    n = tm.taps_blocks_per_sm(tile)
    assert n >= 1
    assert n * (tm.taps_smem_bytes(tile) + 1024) <= tm.SMEM_PER_SM
    assert n * 32 * tm.TAPS_WARPS * (128 if n > 1 else 255) <= 65536


@pytest.mark.parametrize("piece", ["mlp_fc1", "mlp_taps", "mlp_fc1/plan", "mlp_taps/plan"])
def test_wrappers_on_cpu_are_the_plain_versions(piece):
    """Each K5 wrapper, given CPU tensors, returns its plain version's result bit for
    bit and launches nothing; `mlp_fc1/plan` with a plan other than its own."""
    piece, _, with_plan = piece.partition("/")
    g = torch.Generator().manual_seed(0)
    H, W, cin, hid, cout = 6, 5, 16, 128, 16

    def r(*s):
        return torch.randn(s, generator=g)

    args = {"mlp_fc1": ((r(2, H * W, cin), r(hid, cin), r(hid), r(hid), r(hid)), {}),
            "mlp_taps": ((r(2, H * W, hid), r(19, hid, hid), r(hid), r(hid), r(hid),
                          r(cout, hid), r(cout), r(cout), r(cout)), dict(H=H, W=W))}[piece]
    plan = {"plan": {"mlp_fc1": (2, 3), "mlp_taps": (128, 3)}[piece]} if with_plan else {}
    tm.reset_launches()
    got = getattr(tm, piece)(*args[0], **args[1], **plan)
    assert torch.equal(got, getattr(tm, piece + "_reference")(*args[0], **args[1]))
    assert sum(tm.LAUNCHES.values()) == 0


def test_the_two_kernel_families_share_one_gelu():
    """K1 and K5 build their GELU from the same text (between the GELU markers of
    csrc/mit_block/common.cuh and csrc/rssformer/common.cuh); the card test that holds it
    to the formula with the IEEE division on every input runs K1's copy."""
    from representationlearning_tpu_torch.ops import _build

    def gelu_text(lib):
        s = (_build.CSRC / lib / "common.cuh").read_text()
        return s[s.index("// ---- GELU with"): s.index("// ---- end of the GELU")]

    assert gelu_text("mit_block") == gelu_text("rssformer")


# HRNetV2's transformer block runs K5 at dim 18 / 32 / 40 / 48 (JAX's models/hrnet.py:27-30)
# with hid = 4 dim (models/rssformer_modules.py:375): the widths the kernels take since
# they take f32 and every HRNetV2 width
HRNET_DIMS = (18, 32, 40, 48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [18, 40, 48])
def test_fused_mlp_dwbn_reference_at_hrnet_widths_matches_jax(dim, dtype):
    """The plain K5 at hid = 4 dim against JAX's reference, at the tolerances above: f32
    within F32_ATOL, bf16 within 2e-3 of the largest magnitude (the bf16 test's bound)."""
    H, W = 9, 14
    x, jp, tp = _setup(H, W, dim, 4 * dim, dim, seed=dim)
    want = np.asarray(jm.fused_mlp_dwbn_reference(jnp.asarray(x), jp, H=H, W=W,
                                                  dtype=getattr(jnp, dtype)))
    got = tm.fused_mlp_dwbn_reference(torch.from_numpy(x), tp, H=H, W=W,
                                      dtype=getattr(torch, dtype)).numpy()
    assert got.shape == (2, H * W, dim)
    atol = F32_ATOL if dtype == "float32" else 2e-3 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_fused_mlp_dwbn_at_dim_18_matches_the_pallas_kernel():
    """dim 18, hid 72 on an 8 x 8 plane against the Pallas kernel in interpret mode."""
    H = W = 8
    x, jp, tp = _setup(H, W, 18, 72, 18, seed=18)
    want = np.asarray(jm.fused_mlp_dwbn_pallas(jnp.asarray(x), jp, H=H, W=W, interpret=True))
    got = tm.fused_mlp_dwbn(torch.from_numpy(x), tp, H=H, W=W)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", HRNET_DIMS)
def test_zero_padding_to_the_kernel_widths_changes_no_output(dim, dtype):
    """The wrappers pad the weights and vectors with zeros to the kernels' widths
    (`padded_hid`, inputs and outputs to 16): through the plain versions, the padded
    hidden features are exactly 0 and the output is the unpadded one, but for the
    order of the sums over the longer rows (the tolerances above)."""
    dt = getattr(torch, dtype)
    H, W, hid = 5, 7, 4 * dim
    hp, cp = tm.padded_hid(hid), -(-dim // 16) * 16
    assert hp == {18: 96, 32: 128, 40: 160, 48: 192}[dim]
    x, _, tp = _setup(H, W, dim, hid, dim, seed=dim)
    xt = torch.from_numpy(x)
    w1, taps = tp["fc1_weight"].reshape(hid, dim).to(dt), tm.tap_weights(tp).to(dt)
    w2 = tp["fc2_weight"].reshape(dim, hid).to(dt)
    v1 = [tp[k] for k in ("fc1_bias", "bn1_scale", "bn1_shift")]
    v2 = [tp[k] for k in ("dw_bias", "bn2_scale", "bn2_shift")]
    v3 = [tp[k] for k in ("fc2_bias", "bn3_scale", "bn3_shift")]
    h = tm.mlp_fc1_reference(xt, w1, *v1, dtype=dt)
    want = tm.mlp_taps_reference(h, taps, *v2, w2, *v3, H=H, W=W, dtype=dt)
    hpad = tm.mlp_fc1_reference(torch.nn.functional.pad(xt, (0, -(-dim // 16) * 16 - dim)),
                                tm._pad(w1, hp, -(-dim // 16) * 16), *(tm._pad(v, hp) for v in v1),
                                dtype=dt)
    assert hpad.shape == (2, H * W, hp) and not hpad[..., hid:].any()
    got = tm.mlp_taps_reference(hpad, tm._pad(taps, 19, hp, hp), *(tm._pad(v, hp) for v in v2),
                                tm._pad(w2, cp, hp), *(tm._pad(v, cp) for v in v3), H=H, W=W,
                                dtype=dt)
    atol = F32_ATOL if dtype == "float32" else 2e-3 * want.abs().max().item()
    assert not got[..., dim:].any()
    np.testing.assert_allclose(got[..., :dim].numpy(), want.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", HRNET_DIMS)
def test_plans_at_hrnet_widths_fit_and_cover_every_token_once(dim, dtype):
    """At each HRNetV2 width and compute dtype: fc1's and the taps' plans fit 227 KB, the
    ring keeps at least three slots, fc2's weight fits, and the plans laid out as the
    kernels walk them cover every tile of tokens exactly once: the predict's branch-0
    plane (8 x 128 x 128), the edge planes of the card tests, and one token."""
    dt, hid = getattr(torch, dtype), 4 * dim
    for M in (8 * 128 * 128, 2 * 7 * 9, 1):
        plan = tm.fc1_plan(M, dim, hid, dt)
        assert tm.check_fc1_plan(plan, dim, hid, dt) == plan
        assert tm.fc1_smem_bytes(dim, plan[0], hid, dt) <= tm.SMEM_LIMIT
        if dt == torch.float32:
            _fc1_f32_walk_covers_every_token_once(M, dim, hid, plan)
            continue
        warps, per = plan
        tiles = -(-M // tm.FC1_ROWS)
        blocks = -(-(-(-tiles // warps)) // per)
        b, i, w = np.meshgrid(np.arange(blocks), np.arange(per), np.arange(warps),
                              indexing="ij")
        tile = ((b * per + i) * warps + w).ravel()
        assert (np.bincount(tile[tile < tiles], minlength=tiles) == 1).all()
    assert -(-dim // 16) * 16 <= tm.taps_cout_max(hid, dt)
    for B, H, W in ((8, 128, 128), (2, 7, 9), (1, 20, 45), (1, 1, 1)):
        tile, blocks = tm.taps_plan(B, H, W, dim, hid, dt)
        assert tm.check_taps_plan((tile, blocks), hid) == (tile, blocks)
        assert tm.taps_smem_bytes(tile, hid, dt) <= tm.SMEM_LIMIT
        assert tm.taps_stages(tile, hid, dt) >= 3
        assert tm.padded_hid(hid) % tm.taps_bk(hid, dt) == 0
        M = B * H * W
        tiles = -(-M // tile)
        walk = np.concatenate([np.arange(b, tiles, blocks) for b in range(blocks)])
        assert (np.bincount(walk, minlength=tiles) == 1).all()
        assert blocks <= tm.taps_blocks_per_sm(tile, hid, dt) * tm.TAPS_SMS


def test_compute_dtype_takes_f32_and_bf16_and_refuses_f16():
    """One check for K1, K5 and K6 (`ops/_build.py::compute_dtype`): float32 and bfloat16
    pass, float16 raises with the kernel's name."""
    from representationlearning_tpu_torch.ops import _build
    from representationlearning_tpu_torch.ops import mit_block as tmb

    for check, name in ((tmb._compute_dtype, "K1"), (tm._compute_dtype, "K5"),
                        (lambda d: _build.compute_dtype(d, "K6"), "K6")):
        check(torch.float32)
        check(torch.bfloat16)
        with pytest.raises(NotImplementedError, match=f"{name} takes compute dtype float32 or "
                                                      "bfloat16"):
            check(torch.float16)


# ----------------------------------- fc1 with f32 operands: the 3xTF32 wgmma kernel
def _fc1_f32_walk_covers_every_token_once(M, cin, hid, plan):
    """Laid out as `fc1_wg_kernel` walks it: block (b, s) of the grid (blocks, hp / tile)
    takes the 128-row tiles b, b + blocks, ..., each as two 64-row halves (the last tile's
    second half dropped where it starts at or past M), and the features [s tile, (s + 1)
    tile). Every (token, feature) is computed exactly once, and the grid is one wave."""
    tile, blocks = plan
    hp = tm.padded_hid(hid)
    assert hp % tile == 0 and blocks >= 1
    tiles = -(-M // tm.FC1_F32_ROWS)
    rows = np.zeros(M, int)
    for b in range(blocks):
        mine = (tiles - 1 - b) // blocks + 1 if b < tiles else 0
        halves = [(b + (f // 2) * blocks) * 128 + (f % 2) * 64 for f in range(2 * mine)]
        if halves and halves[-1] >= M:
            halves.pop()
        for r0 in halves:
            assert r0 < M
            rows[r0:r0 + 64] += 1
    assert (rows == 1).all()   # each slice of features the same walk
    assert blocks * (hp // tile) <= tm.fc1_blocks_per_sm(cin, tile, hid, torch.float32) * tm.FC1_SMS


# the planes of phase 7l's K5 checks (chip_smoke.py `_k5_widths`) and the w32 predict's
FC1_F32_PLANES = [(8, 128, 128), (4, 128, 128), (2, 96, 96), (2, 7, 9), (1, 20, 45), (3, 13, 29),
                  (1, 1, 1)]


@pytest.mark.parametrize("dim", HRNET_DIMS)
@pytest.mark.parametrize("B,H,W", FC1_F32_PLANES)
def test_fc1_f32_plan_covers_every_token_once_in_one_wave(dim, B, H, W):
    """The f32 plan at each HRNetV2 width and phase-7l plane: the whole padded width as
    one tile (its w1 fits beside the ring), one block a 128-row tile up to one wave of
    the 132 SMs, each (token, feature) once; every other plan the wrapper takes (each
    tile, 1 to 132 blocks) covers them once too."""
    f32, hid, M = torch.float32, 4 * dim, B * H * W
    hp = tm.padded_hid(hid)
    plan = tm.fc1_plan(M, dim, hid, f32)
    assert plan == (hp, min(-(-M // 128), tm.FC1_SMS)) == tm.fc1_plan(M, dim, hid, f32)
    assert tm.check_fc1_plan(plan, dim, hid, f32) == plan
    for pl in [plan] + [(t, n) for t in tm.fc1_f32_tiles(dim, hid) for n in (1, 3, 132 * t // hp)]:
        _fc1_f32_walk_covers_every_token_once(M, dim, hid, pl)


@pytest.mark.parametrize("hid", [72, 128, 160, 192])
def test_fc1_f32_shared_memory_fits_at_each_hidden_width(hid):
    """`fc1_wg_kernel`'s shared memory (mlp_dwbn_fc1_f32.cu's `f1_layout`) at every input
    width: its tiles keep at least two ring stages within 227 KB and take more than half
    an SM (one block an SM); the whole padded width fits up to cin 64 at every hp (two
    chunks of w1, big and small; HRNetV2's widths among them) and not at cin 256; the
    32-feature tile fits everywhere; rows of x by tensor map at cin % 4 == 0, else as
    they lie."""
    f32, hp = torch.float32, tm.padded_hid(hid)
    for cin in range(1, 257):
        tiles = tm.fc1_f32_tiles(cin, hid)
        assert tm.FC1_F32_NARROW in tiles and set(tiles) <= {hp, tm.FC1_F32_NARROW}
        for t in tiles:
            smem, stages = tm.fc1_smem_bytes(cin, t, hid, f32), tm.fc1_f32_stages(cin, t)
            nch = -(-cin // 32)
            stage = nch * 64 * 128 if cin % 4 == 0 else max(4096, -(-(256 * cin + 16) // 1024) * 1024)
            fixed = 2048 + -(-(12 * t) // 1024) * 1024 + 2 * nch * t * 128 + 8 * 2 * 2048
            assert smem == fixed + stages * stage <= tm.SMEM_LIMIT
            assert 2 <= stages <= tm.FC1_F32_MAX_STAGES
            assert stages == tm.FC1_F32_MAX_STAGES or smem + stage > tm.SMEM_LIMIT
            assert smem + 1024 > tm.SMEM_PER_SM // 2
            assert tm.fc1_blocks_per_sm(cin, t, hid, f32) == 1
        assert (hp in tiles) == (tm.fc1_f32_stages(cin, hp) >= 2)
    assert all(hp in tm.fc1_f32_tiles(c, hid) for c in range(1, 65))
    assert hp not in tm.fc1_f32_tiles(256, hid)


def test_fc1_f32_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too():
    """With f32 operands a plan is (tile, blocks): a tile other than hp and 32, hp where
    w1 does not fit (cin 256), no block, the bf16 kernel's (warps, per), and what is no
    pair raise on CPU tensors as on the card; (32, blocks) runs the plain version."""
    f32 = torch.float32
    x, w1, v = torch.zeros(1, 16, 256), torch.zeros(192, 256), torch.zeros(192)
    for plan in ((64, 1), (96, 1), (192, 1), (32, 0), (8, 1), (192,), "ab"):
        with pytest.raises(ValueError, match="plan"):
            tm.mlp_fc1(x, w1, v, v, v, dtype=f32, plan=plan)
    tm.reset_launches()
    assert tm.mlp_fc1(x, w1, v, v, v, dtype=f32, plan=(32, 5)).shape == (1, 16, 192)
    assert tm.fc1_plan(16, 256, 192, f32) == (32, 1) and sum(tm.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="tile"):
        tm.check_fc1_plan((160, 1), 48, 192, f32)


@pytest.mark.parametrize("dim", HRNET_DIMS)
def test_fc1_f32_plain_version_at_the_padded_width_is_jax_mlp_math_step_1(dim):
    """What the f32 kernel computes, `mlp_fc1_reference` on w1 and the vectors zero-padded
    to (hp, cinp) as the wrapper pads them, is step (1) of JAX's `_mlp_math` (fc1, bn1,
    GELU, f32 operands) on its first hid features, within the file's f32 bound, and 0 on
    the padded ones."""
    hid = 4 * dim
    hp, cinp = tm.padded_hid(hid), -(-dim // 16) * 16
    x, jp, tp = _setup(9, 11, dim, hid, dim, seed=dim + 1)
    xt = torch.from_numpy(x)
    w1 = tp["fc1_weight"].reshape(hid, dim)
    v1 = [tp[k] for k in ("fc1_bias", "bn1_scale", "bn1_shift")]
    got = tm.mlp_fc1_reference(torch.nn.functional.pad(xt, (0, cinp - dim)), tm._pad(w1, hp, cinp),
                               *(tm._pad(v, hp) for v in v1), dtype=torch.float32)
    assert got.shape == (2, 9 * 11, hp) and not got[..., hid:].any()
    f = jnp.float32
    want = jm._gelu((jm._mm(jnp.asarray(x), jp["fc1_kernel"], f) + jp["fc1_bias"]) * jp["bn1_scale"]
                    + jp["bn1_shift"])
    np.testing.assert_allclose(got[..., :hid].numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


# ----------------------------------- taps with f32 operands: the 3xTF32 wgmma kernel
@pytest.mark.parametrize("dim,stages", [(18, 5), (32, 4), (40, 4), (48, 3)])
def test_taps_f32_ring_fits_the_wgmma_kernel(dim, stages):
    """With f32 operands the taps run on the wgmma kernel: one tile of 128 tokens, K steps
    of 32 features (128-byte rows), as many ring slots as 227 KB holds beside the barriers
    and 1 KB of alignment (mlp_dwbn.cuh's `twg_smem`), at least three (two the consumers
    hold, one loading), one block an SM; its plan one block a tile up to one an SM."""
    f32, hid = torch.float32, 4 * dim
    hp = tm.padded_hid(hid)
    assert tm.taps_tiles(hid, f32) == (128,) and tm.taps_bk(hid, f32) == 32
    assert tm.taps_stages(128, hid, f32) == stages >= 3
    smem = tm.taps_smem_bytes(128, hid, f32)
    assert smem == 1024 + 3 * 8 * 8 + stages * (128 + 2 * hp) * 128 <= tm.SMEM_LIMIT
    assert smem + (128 + 2 * hp) * 128 > tm.SMEM_LIMIT or stages == tm.TAPS_MAX_STAGES_F32
    assert tm.taps_blocks_per_sm(128, hid, f32) == 1
    for B, H, W in ((8, 128, 128), (3, 13, 29), (1, 1, 1)):
        tiles = -(-(B * H * W) // 128)
        assert tm.taps_plan(B, H, W, dim, hid, f32) == (128, min(tiles, tm.TAPS_SMS))


@pytest.mark.parametrize("plan", [(256, 1), (256, 132), (64, 1), (128, 0)])
def test_taps_f32_refuses_a_plan_of_the_bf16_kernel(plan):
    """The bf16 kernel's 256-token tile, and what neither kernel takes, raise with f32
    operands on CPU tensors as on the card; 128 runs."""
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 12, 128, generator=g), torch.randn(19, 128, 128, generator=g),
            *(torch.randn(128, generator=g) for _ in range(3)),
            torch.randn(16, 128, generator=g), *(torch.randn(16, generator=g) for _ in range(3)))
    with pytest.raises(ValueError, match="plan"):
        tm.mlp_taps(*args, H=3, W=4, dtype=torch.float32, plan=plan)
    assert tm.mlp_taps(*args, H=3, W=4, dtype=torch.float32, plan=(128, 1)).shape == (1, 12, 16)
