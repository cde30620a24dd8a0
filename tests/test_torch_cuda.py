"""The CUDA kernels (K1 and its PRE_SR variant, K2-K6) against their plain versions, on a
CUDA card.

Small and ragged shapes (token counts, key counts and widths that no tile
divides, an empty key set, both head widths) complement ``chip_smoke.py``, which
checks the kernels at the model's own shapes. Every test here needs the card and
skips without one. The file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""
import math

import pytest
import torch

from chip_smoke import (K1_F32_ATTN_KEYS, K1_F32_ATTN_QUERIES, K1_F32_SR_EDGES, affinity_plans,
                        attention_plans, bwd_plans, drfl_agreement, drfl_card_vs_cpu, fc1_f32_plans,
                        isa_trap_move, linear_plans, sr_conv_plans, taps_plans, varm_plans)
from representationlearning_tpu_torch.ops import affinity as TA
from representationlearning_tpu_torch.ops import attention as TF
from representationlearning_tpu_torch.ops import isa_attention as TI
from representationlearning_tpu_torch.ops import mit_block as tmb
from representationlearning_tpu_torch.ops import mlp_dwbn as TM
from representationlearning_tpu_torch.ops import varm as TV

pytestmark = pytest.mark.cuda

# Same tolerances and reasons as chip_smoke.py: identical bf16 operands, f32
# sums in another order; the attention output also sees a few probabilities
# rounded to the neighbouring bf16 value.
TOL = {"ln_stats": 1e-5, "linear": 1e-4, "sr_conv": 1e-4, "attention": 1e-3,
       "logits": 1e-4, "dwconv_gelu": 1e-5}
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


def _rand(gen, *shape, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).to(dev)


def test_ln_stats(dev):
    g = torch.Generator().manual_seed(0)
    x = _rand(g, 3, 37, 320, dev=dev, scale=2.0, shift=0.5)
    _close(tmb.ln_stats(x), tmb.ln_stats_reference(x), TOL["ln_stats"])


@pytest.mark.parametrize("M,Nout,K,ln,res", [(100, 96, 64, True, False),
                                             (130, 64, 160, False, True),
                                             (1, 2048, 512, True, True),
                                             # the kernel's edges: M of one row and of one
                                             # tile of rows less or more one (64 and 128),
                                             # Nout that no column tile divides, K of one
                                             # step, of two and of 64 steps
                                             (1, 96, 32, False, True),
                                             (63, 640, 64, True, False),
                                             (65, 1280, 2048, False, False),
                                             (127, 96, 2048, True, True),
                                             (129, 640, 32, True, True),
                                             (129, 1280, 64, False, True),
                                             # rows that 16 bytes do not divide (scalar stores)
                                             (65, 90, 64, True, True)])
def test_linear(dev, M, Nout, K, ln, res):
    """Within the tolerance of the plain version; a second run and every tile the
    plan can choose, walked one and three M tiles a block, give the same bits."""
    g = torch.Generator().manual_seed(M)
    a = _rand(g, M, K, dev=dev)
    w = _rand(g, Nout, K, dev=dev, scale=0.05).to(BF16)
    kw = dict(bias=_rand(g, Nout, dev=dev))
    if ln:
        kw.update(stats=tmb.ln_stats_reference(a), ln_w=_rand(g, K, dev=dev, shift=1.0),
                  ln_b=_rand(g, K, dev=dev, scale=0.1))
    if res:
        kw["residual"] = _rand(g, M, Nout, dev=dev)
    before = tmb.LAUNCHES["linear"]
    got = tmb.linear(a, w, **kw)
    _close(got, tmb.linear_reference(a, w, **kw), TOL["linear"])
    assert tmb.LAUNCHES["linear"] == before + 1
    assert torch.equal(tmb.linear(a, w, **kw), got)
    for tile in tmb.LINEAR_TILES:
        for per in (1, 3):
            assert torch.equal(tmb.linear(a, w, plan=(tile, per), **kw), got), (tile, per)


def test_linear_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    a, w, b = _rand(g, 8, 64, dev=dev), _rand(g, 96, 64, dev=dev).to(BF16), _rand(g, 96, dev=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        tmb.linear(a[:, :48].contiguous(), w[:, :48].contiguous(), b)
    with pytest.raises(ValueError, match="aligned"):
        tmb.linear(torch.empty(8 * 64 + 1, device=dev)[1:].view(8, 64), w, b)
    with pytest.raises(ValueError, match="plan"):      # no such tile
        tmb.linear(a, w, b, plan=((64, 96), 1))
    with pytest.raises(ValueError, match="plan"):      # no M tile a block
        tmb.linear(a, w, b, plan=((64, 64), 0))
    with pytest.raises(ValueError, match="plan"):      # the f32 kernel's tile, with bf16
        tmb.linear(a, w, b, plan=((128, 64), 1))
    with pytest.raises(ValueError, match="plan"):      # the bf16 kernel's tile, with f32
        tmb.linear(a, w.float(), b, plan=((64, 128), 1), dtype=torch.float32)
    assert torch.isfinite(tmb.linear(a, w, b)).all()           # and goes on working


@pytest.mark.parametrize("H,W,C,sr", [(13, 11, 64, 4), (16, 16, 32, 8), (9, 7, 96, 2)])
def test_sr_conv(dev, H, W, C, sr):
    g = torch.Generator().manual_seed(H * W)
    x = _rand(g, 2, H * W, C, dev=dev)
    args = (x, tmb.ln_stats_reference(x), _rand(g, C, dev=dev, shift=1.0),
            _rand(g, C, dev=dev, scale=0.1),
            _rand(g, C, sr * sr * C, dev=dev, scale=0.05).to(BF16), _rand(g, C, dev=dev))
    _close(tmb.sr_conv(*args, H=H, W=W, sr=sr), tmb.sr_conv_reference(*args, H=H, W=W, sr=sr),
           TOL["sr_conv"])


@pytest.mark.parametrize("N,Nk,C,nh", [(70, 50, 64, 1), (64, 130, 128, 2), (33, 200, 160, 5),
                                       (65, 0, 64, 1)])
def test_attention_with_export(dev, N, Nk, C, nh):
    g = torch.Generator().manual_seed(N + Nk)
    q, kv = _rand(g, 2, N, C, dev=dev), _rand(g, 2, Nk, 2 * C, dev=dev)
    out, logits = tmb.attention(q, kv, nh=nh, export=True)
    want, want_logits = tmb.attention_reference(q, kv, nh=nh, dtype=BF16, export=True)
    assert logits.shape == (2, nh, N, Nk)
    _close(out, want, TOL["attention"])
    if Nk:
        _close(logits, want_logits, TOL["logits"])
    else:
        assert not out.any()
    plain_out, none = tmb.attention(q, kv, nh=nh)
    assert none is None and torch.equal(plain_out, out)


@pytest.mark.parametrize("N", [9, 36])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("off", [-1, 0, 1])
def test_attention_around_the_one_pass_bound(dev, off, hd, N):
    """The last key count of the one-pass form, the bound and the first count of
    the streaming form, exporting (so at Nk <= bound too); query counts below one
    tile; two runs give equal bits."""
    from representationlearning_tpu_torch.ops import _build
    assert _build.load_library("mit_block").k1_attention_one_pass_keys() == tmb.ATTN_ONE_PASS_KEYS
    Nk, nh = tmb.ATTN_ONE_PASS_KEYS + off, 2
    g = torch.Generator().manual_seed(Nk + hd + N)
    q, kv = _rand(g, 2, N, nh * hd, dev=dev), _rand(g, 2, Nk, 2 * nh * hd, dev=dev)
    before = tmb.LAUNCHES["attention"]
    out, logits = tmb.attention(q, kv, nh=nh, export=True)
    assert tmb.LAUNCHES["attention"] == before + 1
    want, want_logits = tmb.attention_reference(q, kv, nh=nh, dtype=BF16, export=True)
    _close(out, want, TOL["attention"])
    _close(logits, want_logits, TOL["logits"])
    again, logits2 = tmb.attention(q, kv, nh=nh, export=True)
    assert torch.equal(out, again) and torch.equal(logits, logits2)
    assert torch.equal(tmb.attention(q, kv, nh=nh)[0], out)


@pytest.mark.parametrize("Nk", [400, 1024, 1030])
def test_attention_streaming_form(dev, Nk):
    """Key counts that 64 and 4 do and do not divide, token counts that 64 does not."""
    g = torch.Generator().manual_seed(Nk)
    q, kv = _rand(g, 2, 130, 128, dev=dev), _rand(g, 2, Nk, 256, dev=dev)
    out, logits = tmb.attention(q, kv, nh=2, export=True)
    want, want_logits = tmb.attention_reference(q, kv, nh=2, dtype=BF16, export=True)
    _close(out, want, TOL["attention"])
    _close(logits, want_logits, TOL["logits"])
    assert torch.equal(tmb.attention(q, kv, nh=2, export=True)[1], logits)


# the f32 attention (3xTF32 `wgmma`, one pass with an online softmax) against its plain
# version in f32: f32 sums in another order (chip_smoke.F32_PIECE_TOL, LOGIT_TOL)
F32_ATTN_TOL = 1e-4


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("Nk", K1_F32_ATTN_KEYS)
def test_attention_f32_at_the_edges_every_plan_gives_equal_bits(dev, Nk, hd):
    """Phase 7l's edges: key counts around the key tile, the CLIs' 25 / 100 / 225 / 400 /
    900 (unaligned export rows at 25 and 225), 1024; query counts around a warpgroup's and
    a block's queries; with and without export; a rerun and every plan give equal bits;
    one launch a call."""
    nh = 2
    C = nh * hd
    g = torch.Generator().manual_seed(Nk + hd)
    for N in K1_F32_ATTN_QUERIES:
        q, kv = _rand(g, 2, N, C, dev=dev), _rand(g, 2, Nk, 2 * C, dev=dev)
        for export in (False, True):
            before = tmb.LAUNCHES["attention"]
            out, logits = tmb.attention(q, kv, nh=nh, dtype=torch.float32, export=export)
            assert tmb.LAUNCHES["attention"] == before + 1
            want, want_logits = tmb.attention_reference(q, kv, nh=nh, dtype=torch.float32,
                                                        export=export)
            _close(out, want, F32_ATTN_TOL)
            if export:
                _close(logits, want_logits, TOL["logits"])
            for plan in [None] + attention_plans(tmb, 2, N, Nk, C, nh):
                again = tmb.attention(q, kv, nh=nh, dtype=torch.float32, export=export, plan=plan)
                assert torch.equal(again[0], out)
                assert not export or torch.equal(again[1], logits)


def test_attention_f32_refuses_what_the_kernel_does_not_take(dev):
    """A plan the f32 kernel lacks, and q that is not 16-byte aligned, raise before a
    launch; the kernel's shared memory is the plan's."""
    from representationlearning_tpu_torch.ops import _build
    lib = _build.load_library("mit_block")
    for hd in (32, 64):
        for queries in tmb.ATTN_WG_QUERIES:
            assert lib.k1_attention_wg_smem(hd, queries) == \
                tmb.attention_smem_bytes((queries, 1), hd, torch.float32)
    q, kv = torch.zeros(1, 9, 64, device=dev), torch.zeros(1, 5, 128, device=dev)
    with pytest.raises(ValueError, match="plan"):
        tmb.attention(q, kv, nh=1, dtype=torch.float32, plan=(32, 1))
    with pytest.raises(ValueError, match="aligned"):
        tmb.attention(torch.zeros(9 * 64 + 1, device=dev)[1:].view(1, 9, 64), kv, nh=1,
                      dtype=torch.float32)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("H,C,sr", [(16, 64, 8), (9, 320, 2), (13, 128, 4)])
def test_sr_conv_at_every_number_of_slices(dev, H, C, sr, tile):
    """Every number of K slices a plan can hold (no slice empty), both tile widths:
    within the kernel's tolerance of the plain version, equal bits on a second
    run, one launch counted a call."""
    g = torch.Generator().manual_seed(H * C)
    x = _rand(g, 2, H * H, C, dev=dev)
    args = (x, tmb.ln_stats_reference(x), _rand(g, C, dev=dev, shift=1.0),
            _rand(g, C, dev=dev, scale=0.1),
            _rand(g, C, sr * sr * C, dev=dev, scale=0.05).to(BF16), _rand(g, C, dev=dev))
    want = tmb.sr_conv_reference(*args, H=H, W=H, sr=sr)
    K = sr * sr * C
    counts = tmb.sr_conv_slice_counts(K)
    assert tmb.sr_conv_plan(2 * (H // sr) ** 2, C, K)[1] in counts
    for slices in counts:
        before = tmb.LAUNCHES["sr_conv"]
        got = tmb.sr_conv(*args, H=H, W=H, sr=sr, plan=(tile, slices))
        assert tmb.LAUNCHES["sr_conv"] == before + 1
        _close(got, want, TOL["sr_conv"])
        assert torch.equal(got, tmb.sr_conv(*args, H=H, W=H, sr=sr, plan=(tile, slices)))


def test_redesigned_wrappers_refuse_what_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(0)
    q, kv = _rand(g, 1, 8, 96, dev=dev), _rand(g, 1, 4, 192, dev=dev)
    with pytest.raises(NotImplementedError, match="head dim"):
        tmb.attention(q, kv, nh=2)
    with pytest.raises(ValueError, match="shape"):
        tmb.attention(q, kv[:, :, :96].contiguous(), nh=3)
    with pytest.raises(TypeError):
        tmb.attention(q.to(BF16), kv, nh=3)
    x = _rand(g, 1, 16, 64, dev=dev)
    args = (x, tmb.ln_stats_reference(x), _rand(g, 64, dev=dev), _rand(g, 64, dev=dev),
            _rand(g, 64, 256, dev=dev).to(BF16), _rand(g, 64, dev=dev))
    with pytest.raises(RuntimeError, match="k1_sr_conv"):      # 8 K steps, 9 slices
        tmb.sr_conv(*args, H=4, W=4, sr=2, plan=(64, 9))
    with pytest.raises(RuntimeError, match="k1_sr_conv"):      # no such tile width
        tmb.sr_conv(*args, H=4, W=4, sr=2, plan=(96, 2))
    with pytest.raises(ValueError):
        tmb.sr_conv(x[..., :48].contiguous(), *args[1:], H=4, W=4, sr=2)
    assert torch.isfinite(tmb.sr_conv(*args, H=4, W=4, sr=2)).all()   # and goes on working


@pytest.mark.parametrize("H,W,hid", [(7, 9, 96), (1, 5, 32), (16, 16, 256)])
def test_dwconv_gelu(dev, H, W, hid):
    g = torch.Generator().manual_seed(hid)
    f = _rand(g, 2, H * W, hid, dev=dev)
    w, b = _rand(g, hid, 1, 3, 3, dev=dev, scale=0.3), _rand(g, hid, dev=dev)
    _close(tmb.dwconv_gelu(f, w, b, H=H, W=W), tmb.dwconv_gelu_reference(f, w, b, H=H, W=W),
           TOL["dwconv_gelu"])


def _dwconv_plans():
    """Every run of columns the kernel has, walking 1, 2, 3, 8 and 16 rows."""
    return [(c, r) for c in tmb.DWCONV_COLUMNS for r in (1, 2, 3, 8, 16)]


@pytest.mark.parametrize("hid", [4, 32, 96, 2048])
@pytest.mark.parametrize("H,W", [(1, 1), (1, 15), (2, 3), (3, 3), (5, 2), (5, 5), (15, 1),
                                 (15, 15)])
def test_dwconv_gelu_at_the_edges_every_plan_gives_equal_bits(dev, H, W, hid):
    """Grids of 1, 2, 3, 5 and 15 rows and columns (every tap padding on some side,
    column runs longer than the grid), batch 16: within the plain version's
    tolerance, and a rerun and every plan give the same bits (each output is computed
    by the same instructions whatever the plan); one launch a call."""
    g = torch.Generator().manual_seed(H * 16 + W + hid)
    f = _rand(g, 16, H * W, hid, dev=dev)
    w, b = _rand(g, hid, 1, 3, 3, dev=dev, scale=0.3), _rand(g, hid, dev=dev)
    tmb.reset_launches()
    got = tmb.dwconv_gelu(f, w, b, H=H, W=W)
    _close(got, tmb.dwconv_gelu_reference(f, w, b, H=H, W=W), TOL["dwconv_gelu"])
    assert torch.equal(got, tmb.dwconv_gelu(f, w, b, H=H, W=W))
    for plan in _dwconv_plans():
        assert torch.equal(got, tmb.dwconv_gelu(f, w, b, H=H, W=W, plan=plan)), plan
    assert tmb.LAUNCHES["dwconv_gelu"] == 2 + len(_dwconv_plans())


def test_gelu_as_is_the_formula_with_the_division_on_every_input(dev):
    """The kernels' GELU with the A&S erf, whose 1 / (1 + p|x|) is a refined approximate
    reciprocal and whose sign is copied from x, gives the bits of the same formula
    written with sign(x) and the IEEE division on every one of the 2^32 f32 inputs."""
    from representationlearning_tpu_torch.ops import _build
    assert _build.load_library("mit_block").k1_gelu_as_mismatches() == 0


def test_dwconv_gelu_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    f, w, b = _rand(g, 2, 12, 36, dev=dev), _rand(g, 36, 1, 3, 3, dev=dev), _rand(g, 36, dev=dev)
    odd = _rand(g, 2 * 12 * 36 + 1, dev=dev)[1:].view(2, 12, 36)   # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        tmb.dwconv_gelu(odd, w, b, H=3, W=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tmb.dwconv_gelu(f[..., :34].contiguous(), w[:34].contiguous(), b[:34].contiguous(),
                        H=3, W=4)
    with pytest.raises(ValueError, match="plan"):
        tmb.dwconv_gelu(f, w, b, H=3, W=4, plan=(3, 2))
    assert torch.isfinite(tmb.dwconv_gelu(f, w, b, H=3, W=4)).all()   # and goes on working


@pytest.mark.parametrize("hw,C,sr,nh,export", [(19, 64, 8, 1, False), (13, 128, 4, 2, False),
                                               (8, 512, 1, 8, True), (4, 64, 8, 1, False)])
def test_fused_block_matches_plain(dev, hw, C, sr, nh, export):
    """The whole block, kernels against plain version, bf16 compute on a bf16
    stream (2e-2 of the largest magnitude: bf16 rounding flips propagate, as
    in chip_smoke.py). The last geometry has no keys (grid below the stride)."""
    from representationlearning_tpu_torch.models.layers import init_weights
    from representationlearning_tpu_torch.models.mit import FusedBlock

    g = torch.Generator().manual_seed(hw + C)
    blk = FusedBlock(C, nh, 4.0, sr, export_attn=export, dtype=BF16).eval()
    init_weights(blk, g)
    p = {k: v.detach().to(dev) for k, v in blk.kernel_params().items()}
    x = _rand(g, 2, hw * hw, C, dev=dev).to(BF16)
    with torch.no_grad():
        got = tmb.fused_block(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=BF16, export=export)
        want = tmb.fused_block_reference(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=BF16,
                                         export=export)
    for a, b in zip(got if export else (got,), want if export else (want,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item(), err


def test_cuda_path_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 16, 64, device=dev)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tmb.fused_block(x, {}, H=4, W=4, sr=1, nh=1, dtype=torch.float16)
    w = torch.zeros(64, 64, device=dev)  # f32 weight: the kernel takes bf16
    with pytest.raises(TypeError):
        tmb.linear(x, w, torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        tmb.ln_stats(torch.zeros(64, 16, device=dev).t())
    with pytest.raises(ValueError, match="on cpu"):
        tmb.linear(x, w.to(BF16), torch.zeros(64))


# ------------------------------------------------------------------ K2, K3
SCD_DILATIONS = (1, 2, 4, 8, 12, 24)


def _image(gen, B, H, W, dev, border=False):
    img = torch.rand((B, 3, H, W), generator=gen) * 255.0
    if border:  # a constant frame, as a zero-padded crop has after denormalisation
        img[:, :, :, : W // 2] = 116.28
        img[:, :, : H // 2] = 116.28
    return img.to(dev)


@pytest.mark.parametrize("mode", ["par", "pamr", "varm"])
@pytest.mark.parametrize("H,W,dil,border", [(20, 28, (1, 2, 4), False),
                                            (13, 37, SCD_DILATIONS, False),  # H < max dilation
                                            (64, 60, SCD_DILATIONS, True), (1, 5, (1, 3), False)])
def test_affinity_matches_plain(dev, H, W, dil, border, mode):
    """2e-5 on weights in [-w2, 1 + w2]: the sums over K run in another order
    and `expf` differs from `torch.exp` in the last bits."""
    img = _image(torch.Generator().manual_seed(H * W), 2, H, W, dev, border)
    before = TA.LAUNCHES["affinity"]
    got = TA.affinity(img, dil, mode, w1=0.3, w2=0.01)
    assert TA.LAUNCHES["affinity"] == before + 1
    want = TA.affinity_reference(img, dil, mode, w1=0.3, w2=0.01)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-5
    if border:  # every tap of the corner pixel lies in the flat frame: a uniform softmax
        K = 8 * len(dil)
        uniform = {"pamr": 1.0 / K, "varm": (1.0 - 0.01) / K}.get(mode)
        if uniform is not None:
            assert (got[:, :, 0, 0] - uniform).abs().max().item() <= 1e-7


@pytest.mark.parametrize("layout", ["channel_first", "kept_axis"])
@pytest.mark.parametrize("H,W,C,dil,num_iter", [(20, 28, 1, (1, 2, 4), 3),
                                                (13, 37, 5, SCD_DILATIONS, 4),
                                                (33, 40, 18, SCD_DILATIONS, 10),
                                                (16, 16, 7, (1, 2), 1), (9, 9, 3, (2,), 0)])
def test_varm_propagate_equals_plain(dev, H, W, C, dil, num_iter, layout):
    """No fused multiply-add and the plain version's order of summation: equal
    bit for bit."""
    g = torch.Generator().manual_seed(H * W + C)
    masks = torch.rand((2, C, H, W), generator=g).to(dev)
    ref = TA.affinity_reference(_image(g, 2, H, W, dev), dil, "varm")
    if layout == "kept_axis":
        ref = ref[:, :, None]
    before = TV.LAUNCHES["varm_propagate"]
    got = TV.varm_propagate(masks, ref, dil, num_iter)
    assert TV.LAUNCHES["varm_propagate"] == before + num_iter
    assert torch.equal(got, TV.varm_propagate_reference(masks, ref, dil, num_iter))


# the pseudo-label call's planes (18 and 42 mask planes at 160^2) and the edges: a
# plane shorter than the halo, 1 x 1, W not a multiple of 4
REFINE_PLANES = [(2, 18, 160, 160), (1, 42, 160, 160), (2, 5, 13, 37), (2, 18, 33, 40),
                 (2, 3, 9, 9), (2, 2, 1, 1)]


@pytest.mark.parametrize("B,C,H,W", REFINE_PLANES)
def test_varm_propagate_every_plan_equals_plain(dev, B, C, H, W):
    """Every plan, and each plan run twice, equals the plain version bit for bit."""
    g = torch.Generator().manual_seed(B * C * H * W)
    masks = torch.rand((B, C, H, W), generator=g).to(dev)
    ref = TA.affinity_reference(_image(g, B, H, W, dev), SCD_DILATIONS, "varm")
    want = TV.varm_propagate_reference(masks, ref, SCD_DILATIONS, 3)
    plans = varm_plans(TV, B, C, H, W, SCD_DILATIONS)
    assert TV.varm_plan(B, C, H, W, SCD_DILATIONS) in plans
    for plan in plans:
        for _ in range(2):
            before = TV.LAUNCHES["varm_propagate"]
            got = TV.varm_propagate(masks, ref, SCD_DILATIONS, 3, plan=plan)
            assert TV.LAUNCHES["varm_propagate"] == before + 3
            assert torch.equal(got, want), plan


@pytest.mark.parametrize("mode", ["par", "pamr", "varm"])
@pytest.mark.parametrize("B,H,W,dil", [(2, 160, 160, SCD_DILATIONS), (2, 13, 37, SCD_DILATIONS),
                                       (2, 33, 40, SCD_DILATIONS), (2, 9, 9, SCD_DILATIONS),
                                       (1, 1, 1, SCD_DILATIONS), (2, 11, 21, tuple(range(1, 17)))])
def test_affinity_every_plan_gives_equal_bits(dev, B, H, W, dil, mode):
    """Every plan, and each plan run twice, gives the same bits, within 2e-5 of the
    plain version."""
    img = _image(torch.Generator().manual_seed(H * W + 1), B, H, W, dev, border=H > 20)
    want = TA.affinity_reference(img, dil, mode, w1=0.3, w2=0.01)
    first = None
    plans = affinity_plans(TA, H, W, dil, mode)
    assert TA.affinity_plan(B, H, W, dil, mode) in plans
    for plan in plans:
        for _ in range(2):
            got = TA.affinity(img, dil, mode, w1=0.3, w2=0.01, plan=plan)
            assert (got - want).abs().max().item() <= 2e-5, plan
            first = got if first is None else first
            assert torch.equal(got, first), plan


def test_refine_blocks_per_sm_match_the_estimates(dev):
    from representationlearning_tpu_torch.ops import _build

    lib = _build.load_library("refine")
    for k in TV.VARM_KERNELS:
        smem = TV.varm_geometry(160, 160, SCD_DILATIONS, *k)[2]
        assert lib.k3_varm_blocks_per_sm(*k, smem) == TV.varm_blocks_per_sm(*k, smem), k
    for (rows, held) in TA.AFFINITY_KERNELS:
        for mode in ("par", "varm"):
            smem = TA.affinity_smem_bytes(160, 160, SCD_DILATIONS, mode, rows, held)
            assert (lib.k2_affinity_blocks_per_sm(TA.MODES[mode], rows, held, smem)
                    == TA.affinity_blocks_per_sm(rows, held, mode, smem)), (mode, rows, held)


def test_refine_kernels_refuse_plans_they_do_not_take(dev):
    masks = torch.zeros(1, 2, 8, 8, device=dev)
    ref = torch.zeros(1, 8 * 7, 8, 8, device=dev)
    with pytest.raises(ValueError, match="plan"):   # two pixels a thread hold six dilations
        TV.varm_propagate(masks, ref, tuple(range(1, 8)), 1, plan=(32, 2, 4))
    with pytest.raises(ValueError, match="plan"):
        TV.varm_propagate(masks, ref[:, :8], (1,), 1, plan=(24, 2, 4))
    with pytest.raises(ValueError, match="plan"):
        TA.affinity(torch.zeros(1, 3, 8, 8, device=dev), tuple(range(1, 8)), "varm", plan=(8, 6))


def test_refine_runs_both_kernels(dev):
    from representationlearning_tpu_torch.models import refine as TR

    g = torch.Generator().manual_seed(0)
    imgs, masks = _image(g, 2, 24, 20, dev), torch.rand((2, 5, 12, 10), generator=g).to(dev)
    for fn, mode in ((TR.varm_refine, "varm"), (TR.par_refine, "par"), (TR.pamr_refine, "pamr")):
        k2, k3 = TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]
        got = fn(imgs, masks, dilations=(1, 2, 4), num_iter=3)
        assert (TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]) == (k2 + 1, k3 + 3)
        want = fn(imgs.cpu(), masks.cpu(), dilations=(1, 2, 4), num_iter=3)
        assert (got.cpu() - want).abs().max().item() <= 1e-4, mode
    # the variants' affinity is plain PyTorch; their propagation is K3
    for extra in ("pos", "-var"):
        k2, k3 = TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]
        got = TR.par_variant_refine(imgs, masks, dilations=(1, 2), num_iter=3, extra=extra)
        assert (TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]) == (k2, k3 + 3)
        want = TR.par_variant_refine(imgs.cpu(), masks.cpu(), dilations=(1, 2), num_iter=3,
                                     extra=extra)
        assert (got.cpu() - want).abs().max().item() <= 1e-4, extra


def test_refine_kernels_refuse_what_they_do_not_take(dev):
    img = torch.zeros(1, 3, 8, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        TA.affinity(img.double(), (1,), "par")
    with pytest.raises(ValueError, match=r"\(B, 3, H, W\)"):
        TA.affinity(torch.zeros(1, 4, 8, 8, device=dev), (1,), "par")
    with pytest.raises(ValueError, match="dilations"):
        TA.affinity(img, tuple(range(1, 18)), "par")
    with pytest.raises(ValueError, match="ref on"):
        TV.varm_propagate(torch.zeros(1, 2, 8, 8, device=dev), torch.zeros(1, 8, 8, 8), (1,), 1)


# K4, f32: the same products, summed tile by tile with an online softmax in the
# kernel and in one softmax in the plain version (the JAX package's own test:
# 1e-4 forward, rtol 2e-4 / atol 2e-5 backward). bf16: the kernel rounds p and ds
# to bf16 before their products, the plain version computes in f32 and rounds the
# result: a few bf16 spacings (2^-8 relative) of the largest entry.
FLASH_TOL = {torch.float32: 1e-4, BF16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,Nq,Nk,D", [(3, 70, 9, 64), (2, 1, 1, 32), (5, 130, 257, 32),
                                        (2, 577, 100, 64), (1, 64, 64, 64), (4, 36, 9, 64)])
def test_flash_attention_forward_and_backward(dev, dtype, BH, Nq, Nk, D):
    g = torch.Generator().manual_seed(Nq * Nk)
    q, k, v = (_rand(g, BH, n, D, dev=dev).to(dtype).requires_grad_() for n in (Nq, Nk, Nk))
    cot = _rand(g, BH, Nq, D, dev=dev).to(dtype)
    scale = D ** -0.5
    before = dict(TF.LAUNCHES)
    out = TF.flash_attention(q, k, v, scale)
    grads = torch.autograd.grad(out, (q, k, v), cot)
    again = torch.autograd.grad(TF.flash_attention(q, k, v, scale), (q, k, v), cot)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == {"flash_fwd": before["flash_fwd"] + 2,
                           "flash_bwd": before["flash_bwd"] + 2}
    want = TF.flash_attention_reference(q, k, v, scale)
    want_grads = torch.autograd.grad(want, (q, k, v), cot)
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, want, FLASH_TOL[dtype])
    for got, w, twice in zip(grads, want_grads, again):
        assert got.dtype == dtype and got.shape == w.shape
        _close(got, w, FLASH_TOL[dtype])
        assert torch.equal(got, twice)   # no atomics: the same bits on a rerun


def test_flash_attention_raises_on_what_the_kernel_does_not_take(dev):
    q = torch.zeros(2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="D = 32 or 64"):
        TF.flash_attention(q, q, q, 1.0)
    q = torch.zeros(2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="not contiguous"):
        TF.flash_attention(q, q.transpose(0, 1).contiguous().transpose(0, 1), q, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TF.flash_attention(q.half(), q.half(), q.half(), 1.0)


def test_flash_attention_refuses_a_second_derivative(dev):
    """The backward is a raw kernel launch with no graph of its own."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (_rand(g, 2, n, 64, dev=dev).requires_grad_() for n in (20, 9, 9))
    cot = _rand(g, 2, 20, 64, dev=dev).requires_grad_()
    dq, = torch.autograd.grad(TF.flash_attention(q, k, v, 0.125), q, cot, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def _flash_plans(BH, Nq, Nk, D, dtype):
    """The default plan, and every warp count with one block (which then walks every
    bh), with seven blocks (runs of tiles that cross bh boundaries) and with 264 (two
    an SM: at these shapes more blocks than tiles' worth of warps)."""
    plans = {TF.flash_plan(BH, Nq, Nk, D, dtype)}
    for warps in range(1, TF.FWD_MAX_WARPS + 1):
        plans |= {(warps, 1), (warps, 7), (warps, 132 * 2)}
    return sorted(plans)


def _lse_want(q, k, scale):
    return torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,Nq,Nk,D", [(3, 70, 9, 64), (2, 577, 100, 64), (5, 130, 257, 32),
                                        (2, 300, 257, 64), (2, 200, 256, 64), (40, 36, 9, 64)])
def test_flash_forward_every_plan_gives_equal_bits(dev, dtype, BH, Nq, Nk, D):
    """Blocks that walk several bh (one block), a run of tiles that no warp count divides,
    the resident and the streamed K / V (f32, D 64, Nk 257)."""
    g = torch.Generator().manual_seed(BH * Nq + Nk)
    q, k, v = (_rand(g, BH, n, D, dev=dev).to(dtype) for n in (Nq, Nk, Nk))
    o, lse = TF.flash_forward(q, k, v, D ** -0.5)
    for plan in _flash_plans(BH, Nq, Nk, D, dtype):
        o1, l1 = TF.flash_forward(q, k, v, D ** -0.5, plan)
        assert torch.equal(o1, o) and torch.equal(l1, lse), plan


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Nk", [1, 9, 100, 104, 129, 257])
@pytest.mark.parametrize("Nq", [1, 15, 16, 17, 65])
def test_flash_forward_at_the_edges(dev, dtype, D, Nk, Nq):
    """o within FLASH_TOL of the plain version, lse within 1e-5 of torch.logsumexp of the
    scaled scores, equal bits on a rerun, one launch a call."""
    g = torch.Generator().manual_seed(Nq * 1000 + Nk)
    q, k, v = (_rand(g, 3, n, D, dev=dev).to(dtype) for n in (Nq, Nk, Nk))
    scale = D ** -0.5
    before = TF.LAUNCHES["flash_fwd"]
    o, lse = TF.flash_forward(q, k, v, scale)
    assert TF.LAUNCHES["flash_fwd"] == before + 1
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (3, Nq)
    _close(o, TF.flash_attention_reference(q, k, v, scale), FLASH_TOL[dtype])
    _close(lse, _lse_want(q, k, scale), 1e-5)
    o2, l2 = TF.flash_forward(q, k, v, scale)
    assert torch.equal(o2, o) and torch.equal(l2, lse)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("Nk", [9, 100, 257])
def test_flash_forward_near_one_hot_and_equal_scores(dev, dtype, Nk):
    """Scores scaled by 30 (a softmax that is nearly one-hot, probabilities down to
    exp(-hundreds)), and rows whose scores are all equal (q row 0: a uniform softmax)."""
    g = torch.Generator().manual_seed(Nk)
    q, k, v = (_rand(g, 4, n, 64, dev=dev) for n in (100, Nk, Nk))
    q[:, 7] = 0.0
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for scale in (30 * 64 ** -0.5, 64 ** -0.5):
        o, lse = TF.flash_forward(q, k, v, scale)
        _close(o, TF.flash_attention_reference(q, k, v, scale), FLASH_TOL[dtype])
        _close(lse, _lse_want(q, k, scale), 1e-5)
        _close(o[:, 7], v.float().mean(dim=1), FLASH_TOL[dtype])    # the uniform rows
        _close(lse[:, 7], torch.full((4,), math.log(Nk), device=dev), 1e-6)


# K4 backward against autograd through the plain version: f32 2e-4 (chip_smoke.py's
# FLASH_TOL["bwd"]: the same products in another order, p from the forward's lse); bf16
# as the forward, p and ds rounded to bf16 before their products.
FLASH_BWD_TOL = {torch.float32: 2e-4, BF16: 2e-2}


def _bwd_case(dev, dtype, BH, Nq, Nk, D, seed, scale=None, zero_row=None):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (_rand(g, BH, n, D, dev=dev) for n in (Nq, Nk, Nk, Nq))
    if zero_row is not None:
        q[:, zero_row] = 0.0   # a row of equal scores: a uniform softmax
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    scale = D ** -0.5 if scale is None else scale
    o, lse = TF.flash_forward(q, k, v, scale)
    want = TF.flash_backward_reference(q, k, v, do, scale)
    return (q, k, v, o, lse, do, scale), want


def _close_grads(got, want, dtype):
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape and bool(torch.isfinite(a.float()).all())
        _close(a, w, FLASH_BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("BH,Nq,Nk,D", [(8, 576, 9, 64), (3, 70, 9, 64), (2, 577, 100, 64),
                                        (5, 130, 257, 32), (2, 300, 129, 64), (40, 36, 9, 64)])
def test_flash_backward_every_plan_gives_equal_bits(dev, dtype, BH, Nq, Nk, D):
    """Every plan of chip_smoke.bwd_plans (each tile height with one share, two, seven and one
    tile a share, and bwd_plan's own) within FLASH_BWD_TOL, twice with equal bits; the
    one-share plans cut no bh and give equal bits at every tile height."""
    args, want = _bwd_case(dev, dtype, BH, Nq, Nk, D, seed=BH * Nq + Nk)
    one_share = None
    for plan in bwd_plans(TF, BH, Nq, Nk, D, dtype):
        got = TF.flash_backward(*args, plan=plan)
        again = TF.flash_backward(*args, plan=plan)
        _close_grads(got, want, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), plan
        if plan[1] == 1:
            one_share = one_share or got
            assert all(torch.equal(a, b) for a, b in zip(got, one_share)), plan


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Nk", [1, 9, 16, 100, 128, 129, 300])
@pytest.mark.parametrize("Nq", [1, 15, 16, 17, 65])
def test_flash_backward_at_the_edges(dev, dtype, D, Nk, Nq):
    """dq, dk, dv within FLASH_BWD_TOL of autograd through the plain version, one launch a
    call, equal bits on a rerun."""
    args, want = _bwd_case(dev, dtype, 3, Nq, Nk, D, seed=Nq * 1000 + Nk)
    before = TF.LAUNCHES["flash_bwd"]
    got = TF.flash_backward(*args)
    assert TF.LAUNCHES["flash_bwd"] == before + 1
    _close_grads(got, want, dtype)
    again = TF.flash_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("Nk", [9, 100, 257])
def test_flash_backward_near_one_hot_and_equal_scores(dev, dtype, Nk):
    """Scores scaled by 30 (probabilities down to exp(-hundreds)) and rows of equal scores."""
    for scale in (30 * 64 ** -0.5, 64 ** -0.5):
        args, want = _bwd_case(dev, dtype, 4, 100, Nk, 64, seed=Nk, scale=scale, zero_row=7)
        _close_grads(TF.flash_backward(*args), want, dtype)


def test_flash_backward_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (_rand(g, 2, n, 64, dev=dev) for n in (20, 9, 9, 20))
    o, lse = TF.flash_forward(q, k, v, 0.125)
    for plan in ((8, 1), (16, 0), (16, 3), (64, 2), (16,), "ab"):
        with pytest.raises(ValueError, match="plan"):
            TF.flash_backward(q, k, v, o, lse, do, 0.125, plan=plan)
    with pytest.raises(ValueError, match="lse"):
        TF.flash_backward(q, k, v, o, lse[:, :3], do, 0.125)
    with pytest.raises(TypeError, match="float32"):
        TF.flash_backward(q, k, v, o, lse.double(), do, 0.125)
    assert TF.check_bwd_plan((16, 2), 20, 9, 64, torch.float32) == (16, 2)


def test_tscd_use_flash_runs_k4_forward_and_backward(dev):
    from representationlearning_tpu_torch.models.tscd import TSCD

    gen = torch.Generator().manual_seed(0)
    m = TSCD("mit_b0", 6, use_flash=True, generator=gen).eval()
    ref = TSCD("mit_b0", 6, use_flash=False).eval()
    ref.load_state_dict(m.state_dict())
    x = torch.randn(2, 3, 96, 96, generator=gen).to(dev)
    TF.reset_launches()
    losses = []
    for model in (m, ref):
        cls, seg, _, pred = model(x)
        loss = cls.square().mean() + seg.square().mean() + pred.square().mean()
        loss.backward()
        losses.append(loss.detach())
    assert TF.LAUNCHES == {"flash_fwd": 6, "flash_bwd": 6}
    _close(losses[0], losses[1], 1e-5)
    for (n, a), b in zip(m.named_parameters(), ref.parameters()):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 2e-3 * max(b.grad.abs().max().item(), 1e-6), (n, err)


# ------------------------------------------------------------------ K1' (PRE_SR)
@pytest.mark.parametrize("hw,C,sr,nh", [(19, 64, 8, 1), (13, 128, 4, 2), (8, 320, 2, 5)])
def test_pre_sr_block_matches_plain(dev, hw, C, sr, nh):
    """The PRE_SR variant on the card: q and kv are linears of h and xs handed
    in; one ln_stats, five linears, no sr_conv. Same bound as the whole block."""
    from representationlearning_tpu_torch.models.layers import init_weights
    from representationlearning_tpu_torch.models.mit import FusedBlock

    g = torch.Generator().manual_seed(hw + C)
    blk = FusedBlock(C, nh, 4.0, sr, dtype=BF16, pre_sr=True).eval()
    init_weights(blk, g)
    p = {k: v.detach().to(dev) for k, v in blk.kernel_params().items()}
    x = _rand(g, 2, hw * hw, C, dev=dev).to(BF16)
    kw = dict(H=hw, W=hw, sr=sr, nh=nh, dtype=BF16)
    with torch.no_grad():
        h, xs = tmb.sr_reduce(x, p, H=hw, W=hw, sr=sr, dtype=BF16)
        tmb.reset_launches()
        got = tmb.fused_block(x, p, h=h, xs=xs, **kw)
        assert tmb.LAUNCHES == {"ln_stats": 1, "linear": 5, "sr_conv": 0, "attention": 1,
                                "dwconv_gelu": 1}
        want = tmb.fused_block_reference(x, p, h=h, xs=xs, **kw)
        whole = tmb.fused_block(x, p, **kw)
    for ref in (want, whole):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item(), err


# ------------------------------------------------------------------ K5
def _mlp_params(g, cin, hid, cout, dev):
    def r(*s, sc=1.0, sh=0.0):
        return _rand(g, *s, dev=dev, scale=sc, shift=sh)

    return {"fc1_weight": r(hid, cin, 1, 1, sc=cin ** -0.5), "fc1_bias": r(hid, sc=0.1),
            "bn1_scale": r(hid, sc=0.2, sh=1.0), "bn1_shift": r(hid, sc=0.1),
            "dw1_weight": r(hid, hid, 1, 1, sc=0.05), "dw6_weight": r(hid, hid, 3, 3, sc=0.03),
            "dw12_weight": r(hid, hid, 3, 3, sc=0.03), "dw_bias": r(hid, sc=0.1),
            "bn2_scale": r(hid, sc=0.2, sh=1.0), "bn2_shift": r(hid, sc=0.1),
            "fc2_weight": r(cout, hid, 1, 1, sc=hid ** -0.5), "fc2_bias": r(cout, sc=0.1),
            "bn3_scale": r(cout, sc=0.2, sh=1.0), "bn3_shift": r(cout, sc=0.1)}


@pytest.mark.parametrize("B,H,W,cin,cout", [(2, 7, 9, 32, 32), (1, 5, 30, 16, 48),
                                            (3, 20, 13, 64, 16), (1, 64, 64, 32, 32),
                                            (2, 1, 1, 256, 128)])
def test_fused_mlp_dwbn_matches_plain(dev, B, H, W, cin, cout):
    """K5 and its two pieces against their plain versions: planes below the
    dilations, non-square ones, token counts that 128 does not divide, several
    widths. fc1 stores bf16: equal up to one bf16 spacing (2^-7 of the largest)
    on the few values whose f32 sum lands on the other side of a rounding
    boundary. The taps piece and the whole: such a flipped operand moves an
    output by a bf16 spacing of the hidden value times a weight (about 2e-4; an
    output reads 128 hidden values, so a few percent of the outputs see one);
    1e-2 of the largest magnitude bounds the worst, and all but a thousandth of
    the entries lie within 1e-3."""
    g = torch.Generator().manual_seed(H * W + cin)
    p = _mlp_params(g, cin, 128, cout, dev)
    x = _rand(g, B, H * W, cin, dev=dev)
    w1 = p["fc1_weight"].reshape(128, cin).to(BF16)
    f1 = (w1, p["fc1_bias"], p["bn1_scale"], p["bn1_shift"])
    rest = (TM.tap_weights(p).to(BF16).contiguous(), p["dw_bias"], p["bn2_scale"],
            p["bn2_shift"], p["fc2_weight"].reshape(cout, 128).to(BF16), p["fc2_bias"],
            p["bn3_scale"], p["bn3_shift"])
    TM.reset_launches()
    with torch.no_grad():
        h, hp = TM.mlp_fc1(x, *f1), TM.mlp_fc1_reference(x, *f1)
        out, outp = TM.mlp_taps(hp, *rest, H=H, W=W), TM.mlp_taps_reference(hp, *rest, H=H, W=W)
        got = TM.fused_mlp_dwbn(x, p, H=H, W=W, dtype=BF16)
        want = TM.fused_mlp_dwbn_reference(x, p, H=H, W=W, dtype=BF16)
    assert TM.LAUNCHES == {"mlp_fc1": 2, "mlp_taps": 2}
    assert h.dtype == BF16 and got.dtype == torch.float32 and got.shape == (B, H * W, cout)
    _close(h, hp, 2.0 ** -7)
    for a, b in ((out, outp), (got, want)):
        assert bool(torch.isfinite(a).all())
        _close(a, b, 1e-2)
        far = ((a - b).abs() > 1e-3 * max(1.0, b.abs().max().item())).float().mean().item()
        assert far <= 1e-3, far


def _fc1_plans(cin):
    return [(w, per) for w in (1, 2, 4, 8) for per in (1, 2, 3) if TM.fc1_fits(cin, w)]


@pytest.mark.parametrize("cin", [16, 32, 64, 256])
@pytest.mark.parametrize("M", [1, 17, 1000, 8517])
def test_mlp_fc1_every_plan_gives_equal_bits(dev, cin, M):
    """fc1 at widths of one to sixteen k steps (at 256 only four warps fit a block) and
    token counts that no tile or step divides:
    within one bf16 spacing of the plain version, and a rerun and every plan give the
    same bits; one launch a call."""
    g = torch.Generator().manual_seed(M + cin)
    x = _rand(g, 1, M, cin, dev=dev)
    f1 = (_rand(g, 128, cin, dev=dev, scale=cin ** -0.5).to(BF16),
          _rand(g, 128, dev=dev, scale=0.1),
          _rand(g, 128, dev=dev, scale=0.2, shift=1.0), _rand(g, 128, dev=dev, scale=0.1))
    TM.reset_launches()
    with torch.no_grad():
        h = TM.mlp_fc1(x, *f1)
        _close(h, TM.mlp_fc1_reference(x, *f1), 2.0 ** -7)
        assert torch.equal(h, TM.mlp_fc1(x, *f1))
        for plan in _fc1_plans(cin):
            assert torch.equal(h, TM.mlp_fc1(x, *f1, plan=plan)), plan
    assert TM.LAUNCHES["mlp_fc1"] == 2 + len(_fc1_plans(cin))


def test_mlp_fc1_refuses_what_it_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    f1 = (_rand(g, 128, 32, dev=dev).to(BF16), _rand(g, 128, dev=dev), _rand(g, 128, dev=dev),
          _rand(g, 128, dev=dev))
    odd = _rand(g, 16 * 32 + 1, dev=dev)[1:].view(1, 16, 32)   # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        TM.mlp_fc1(odd, *f1)
    for plan in ((9, 1), (4, 0)):
        with pytest.raises(ValueError, match="plan"):
            TM.mlp_fc1(odd.clone(), *f1, plan=plan)
    assert torch.isfinite(TM.mlp_fc1(odd.clone(), *f1).float()).all()


def _taps_inputs(g, B, H, W, cout, dev):
    p = _mlp_params(g, 32, 128, cout, dev)
    h = TM.mlp_fc1_reference(_rand(g, B, H * W, 32, dev=dev),
                             p["fc1_weight"].reshape(128, 32).to(BF16), p["fc1_bias"],
                             p["bn1_scale"], p["bn1_shift"])
    rest = (TM.tap_weights(p).to(BF16).contiguous(), p["dw_bias"], p["bn2_scale"],
            p["bn2_shift"], p["fc2_weight"].reshape(cout, 128).to(BF16), p["fc2_bias"],
            p["bn3_scale"], p["bn3_shift"])
    return h, rest


@pytest.mark.parametrize("B,H,W,cout", [(4, 128, 128, 32), (2, 64, 64, 32), (2, 96, 96, 16),
                                        (2, 224, 224, 32), (2, 7, 9, 128), (1, 20, 45, 48),
                                        (1, 1, 1, 16), (3, 13, 29, 32)])
def test_mlp_taps_every_plan_gives_equal_bits(dev, B, H, W, cout):
    """taps at the predict shape, TTA planes at batch 2, planes below both dilations,
    one token, and token counts that no tile divides: within K5's tolerance of the
    plain version (1e-2 of the largest, all but a thousandth of the entries within
    1e-3), and a rerun and every plan give the same bits; one launch a call."""
    g = torch.Generator().manual_seed(B * H * W + cout)
    h, rest = _taps_inputs(g, B, H, W, cout, dev)
    plans = taps_plans(TM, B, H, W)
    TM.reset_launches()
    with torch.no_grad():
        out = TM.mlp_taps(h, *rest, H=H, W=W)
        want = TM.mlp_taps_reference(h, *rest, H=H, W=W)
        assert bool(torch.isfinite(out).all()) and out.shape == (B, H * W, cout)
        _close(out, want, 1e-2)
        far = ((out - want).abs() > 1e-3 * max(1.0, want.abs().max().item())).float().mean()
        assert far.item() <= 1e-3, far.item()
        assert torch.equal(out, TM.mlp_taps(h, *rest, H=H, W=W))
        for plan in plans:
            assert torch.equal(out, TM.mlp_taps(h, *rest, H=H, W=W, plan=plan)), plan
    assert TM.LAUNCHES["mlp_taps"] == 2 + len(plans)


def test_mlp_taps_blocks_per_sm_matches_the_estimate(dev):
    """At every padded hidden width, operand type and tile the kernel has, and -1 for the
    tiles and widths it lacks."""
    from representationlearning_tpu_torch.ops import _build

    lib = _build.load_library("rssformer")
    for hp in TM.HIDDEN_WIDTHS:
        for dtype in (torch.float32, BF16):
            f32 = int(dtype == torch.float32)
            for tile in TM.taps_tiles(hp, dtype):
                assert lib.k5_taps_blocks_per_sm(hp, f32, tile) == \
                    TM.taps_blocks_per_sm(tile, hp, dtype), (hp, dtype, tile)
            assert lib.k5_taps_blocks_per_sm(hp, f32, 64) == -1
            assert lib.k5_taps_blocks_per_sm(hp, f32, 512) == -1
    assert lib.k5_taps_blocks_per_sm(160, 0, 256) == -1 and lib.k5_taps_blocks_per_sm(64, 0, 128) == -1
    assert lib.k5_taps_blocks_per_sm(128, 1, 256) == -1   # the f32 kernel has one tile


def test_mlp_taps_refuses_what_it_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    h, rest = _taps_inputs(g, 1, 4, 4, 32, dev)
    odd = torch.zeros(16 * 128 + 1, device=dev, dtype=BF16)[1:].view(1, 16, 128)  # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        TM.mlp_taps(odd, *rest, H=4, W=4)
    for plan in ((64, 1), (512, 1), (128, 0), (256, 3, 1)):
        with pytest.raises(ValueError, match="plan"):
            TM.mlp_taps(h, *rest, H=4, W=4, plan=plan)
    wide = torch.zeros(144, 128, device=dev, dtype=BF16)
    with pytest.raises(NotImplementedError, match="output width up to 128"):
        TM.mlp_taps(h, rest[0], *rest[1:4], wide, *(torch.zeros(144, device=dev),) * 3, H=4, W=4)
    with pytest.raises(ValueError, match="H\\*W"):
        TM.mlp_taps(h, *rest, H=3, W=4)
    assert torch.isfinite(TM.mlp_taps(odd.clone(), *rest, H=4, W=4)).all()


def test_fused_mlp_dwbn_refuses_what_it_does_not_take(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.zeros(1, 16, 32, device=dev)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TM.fused_mlp_dwbn(x, _mlp_params(g, 32, 128, 32, dev), H=4, W=4, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="hidden width up to 192"):
        TM.fused_mlp_dwbn(x, _mlp_params(g, 32, 256, 32, dev), H=4, W=4, dtype=BF16)
    with pytest.raises(NotImplementedError, match="input width up to 256"):
        TM.fused_mlp_dwbn(torch.zeros(1, 16, 272, device=dev), _mlp_params(g, 272, 128, 32, dev),
                          H=4, W=4, dtype=BF16)
    with pytest.raises(ValueError, match="H\\*W"):
        TM.fused_mlp_dwbn(x, _mlp_params(g, 32, 128, 32, dev), H=3, W=4, dtype=BF16)


# --------------------------------------------- K1 and K5 with f32 operands, K5's widths
F32_TOL = 1e-4   # 3xTF32 products (f32 to about 2^-21 of each) against f32 products


@pytest.mark.parametrize("M", [1, 63, 65, 127, 129, 8 * 1024])
@pytest.mark.parametrize("Nout,K", [(96, 32), (95, 64), (640, 2048), (1280, 64), (320, 1280)])
@pytest.mark.parametrize("ln,res", [(False, False), (True, False), (False, True), (True, True)])
def test_linear_f32_every_plan_gives_equal_bits(dev, M, Nout, K, ln, res):
    """The 3xTF32 wgmma kernel around its 128-row tiles (and one of 8192 rows), Nout that
    no column tile divides (95: pairs of columns split, scalar stores), K of one K step
    to 64, LayerNorm and residual on and off: within 1e-4 of max(1, largest) of the plain
    version in f32, and a rerun and every plan (both tiles; one block, three and the
    plan's) give equal bits; one launch a call."""
    g = torch.Generator().manual_seed(M + Nout + K)
    a, w = _rand(g, M, K, dev=dev), _rand(g, Nout, K, dev=dev, scale=K ** -0.5)
    kw = dict(bias=_rand(g, Nout, dev=dev), dtype=torch.float32)
    if ln:
        kw.update(stats=tmb.ln_stats_reference(a), ln_w=_rand(g, K, dev=dev, shift=1.0),
                  ln_b=_rand(g, K, dev=dev, scale=0.1))
    if res:
        kw["residual"] = _rand(g, M, Nout, dev=dev)
    tmb.reset_launches()
    got = tmb.linear(a, w, **kw)
    _close(got, tmb.linear_reference(a, w, **kw), F32_TOL)
    assert torch.equal(got, tmb.linear(a, w, **kw))
    plans = linear_plans(tmb, M, Nout, K, torch.float32)
    for plan in plans:
        assert torch.equal(got, tmb.linear(a, w, plan=plan, **kw)), plan
    assert tmb.LAUNCHES["linear"] == 2 + len(plans)


def _sr_args(g, B, H, W, C, sr, dev, dtype=torch.float32):
    x = _rand(g, B, H * W, C, dev=dev, scale=2.0, shift=0.5)
    return (x, tmb.ln_stats_reference(x), _rand(g, C, dev=dev, shift=1.0),
            _rand(g, C, dev=dev, scale=0.1),
            _rand(g, C, sr * sr * C, dev=dev, scale=(sr * sr * C) ** -0.5).to(dtype),
            _rand(g, C, dev=dev))


@pytest.mark.parametrize("H,C,sr", [(16, 64, 8), (9, 320, 2), (13, 128, 4)])
def test_sr_conv_f32_at_every_number_of_slices(dev, H, C, sr):
    """Every plan of the f32 kernel (64 and 128 rows, the plan's and the widest columns,
    every slice count a cluster holds): within F32_TOL of the plain version and of the
    sliced plain version at its cut, equal bits on a second run."""
    g = torch.Generator().manual_seed(H * C)
    x = _rand(g, 2, H * H, C, dev=dev)
    args = (x, tmb.ln_stats_reference(x), _rand(g, C, dev=dev, shift=1.0),
            _rand(g, C, dev=dev, scale=0.1), _rand(g, C, sr * sr * C, dev=dev, scale=0.05),
            _rand(g, C, dev=dev))
    want = tmb.sr_conv_reference(*args, H=H, W=H, sr=sr, dtype=torch.float32)
    K, M = sr * sr * C, 2 * (H // sr) ** 2
    for plan in sr_conv_plans(tmb, M, C, K):
        got = tmb.sr_conv(*args, H=H, W=H, sr=sr, dtype=torch.float32, plan=plan)
        _close(got, want, F32_TOL)
        _close(got, tmb.sr_conv_sliced_reference(*args, H=H, W=H, sr=sr, slices=plan[1],
                                                 dtype=torch.float32), F32_TOL)
        assert torch.equal(got, tmb.sr_conv(*args, H=H, W=H, sr=sr, dtype=torch.float32,
                                            plan=plan)), plan


@pytest.mark.parametrize("B,H,W,C,sr", K1_F32_SR_EDGES)
def test_sr_conv_f32_at_the_edges(dev, B, H, W, C, sr):
    """The f32 kernel where the copy engine's walk through the windows turns: cropped
    grids, patch rows that cross images, tiles of one row more or less, every tile width;
    at every plan, against the plain version, a rerun giving equal bits."""
    g = torch.Generator().manual_seed(B * H * W + C)
    args = _sr_args(g, B, H, W, C, sr, dev)
    want = tmb.sr_conv_reference(*args, H=H, W=W, sr=sr, dtype=torch.float32)
    K, M = sr * sr * C, B * (H // sr) * (W // sr)
    for plan in sr_conv_plans(tmb, M, C, K):
        got = tmb.sr_conv(*args, H=H, W=W, sr=sr, dtype=torch.float32, plan=plan)
        assert got.shape == (B, (H // sr) * (W // sr), C)
        _close(got, want, F32_TOL)
        assert torch.equal(got, tmb.sr_conv(*args, H=H, W=W, sr=sr, dtype=torch.float32,
                                            plan=plan)), plan


def test_sr_conv_f32_is_one_kernel_and_one_count(dev):
    """An f32 call at the headline's stage-1 geometry is one device kernel, the
    `sr_conv_wg_kernel` (no workspace and no reduction kernel), and one LAUNCHES count;
    the kernel's shared memory and the clusters the card holds are the plan's tables."""
    from torch.profiler import ProfilerActivity, profile

    from representationlearning_tpu_torch.ops import _build
    lib = _build.load_library("mit_block")
    for rows in tmb.SR_WG_ROWS:
        for cols in tmb.SR_WG_COLUMNS:
            assert lib.k1_sr_conv_wg_smem(rows, cols) == \
                tmb.sr_conv_smem_bytes((rows, cols), torch.float32)
            assert [lib.k1_sr_conv_wg_clusters(rows, cols, s)
                    for s in range(1, tmb.SR_WG_MAX_SLICES + 1)] == list(tmb.SR_WG_CLUSTERS)
    g = torch.Generator().manual_seed(1)
    args = _sr_args(g, 8, 128, 128, 64, 8, dev)
    want = tmb.sr_conv(*args, H=128, W=128, sr=8, dtype=torch.float32)
    torch.cuda.synchronize()
    before = tmb.LAUNCHES["sr_conv"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tmb.sr_conv(*args, H=128, W=128, sr=8, dtype=torch.float32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "sr_conv_wg_kernel" in kernels[0], kernels
    assert tmb.LAUNCHES["sr_conv"] == before + 1 and torch.equal(got, want)


def test_sr_conv_f32_refuses_what_the_kernel_does_not_take(dev):
    """A plan the f32 kernel lacks, more than 512 channels, and tokens that are not 16-byte
    aligned raise before a launch."""
    g = torch.Generator().manual_seed(2)
    args = _sr_args(g, 1, 4, 4, 64, 2, dev)
    with pytest.raises(ValueError, match="plan"):
        tmb.sr_conv(*args, H=4, W=4, sr=2, dtype=torch.float32, plan=(64, 2))
    with pytest.raises(ValueError, match="plan"):
        tmb.sr_conv(*args, H=4, W=4, sr=2, dtype=torch.float32, plan=((64, 64), 9))
    wide = _sr_args(g, 1, 2, 2, 544, 2, dev)
    with pytest.raises(ValueError, match="512"):
        tmb.sr_conv(*wide, H=2, W=2, sr=2, dtype=torch.float32)
    x = torch.zeros(16 * 64 + 1, device=dev)[1:].view(1, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        tmb.sr_conv(x, *args[1:], H=4, W=4, sr=2, dtype=torch.float32)
    assert torch.isfinite(tmb.sr_conv(*args, H=4, W=4, sr=2, dtype=torch.float32)).all()


@pytest.mark.parametrize("N,Nk,C,nh", [(70, 50, 64, 1), (64, 255, 128, 2), (33, 257, 160, 5),
                                       (50, 20, 32, 1), (130, 1024, 512, 8)])
def test_attention_f32_with_export(dev, N, Nk, C, nh):
    g = torch.Generator().manual_seed(N + Nk)
    q, kv = _rand(g, 2, N, C, dev=dev), _rand(g, 2, Nk, 2 * C, dev=dev)
    got = tmb.attention(q, kv, nh=nh, dtype=torch.float32, export=True)
    want = tmb.attention_reference(q, kv, nh=nh, dtype=torch.float32, export=True)
    _close(got[0], want[0], F32_TOL)
    _close(got[1], want[1], TOL["logits"])
    again = tmb.attention(q, kv, nh=nh, dtype=torch.float32, export=True)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("hw,C,sr,nh,export", [(19, 64, 8, 1, False), (13, 128, 4, 2, False),
                                               (9, 320, 2, 5, False), (7, 512, 1, 8, True)])
def test_fused_block_f32_matches_plain(dev, hw, C, sr, nh, export):
    """The whole block with f32 operands, f32 tokens, against the plain version at the
    port's f32 end-to-end bound (2e-4 of the largest magnitude)."""
    from representationlearning_tpu_torch.models.layers import init_weights
    from representationlearning_tpu_torch.models.mit import FusedBlock

    g = torch.Generator().manual_seed(hw * C)
    blk = FusedBlock(C, nh, 4.0, sr, export_attn=export).eval()
    init_weights(blk, g)
    p = {k: v.detach().to(dev) for k, v in blk.kernel_params().items()}
    x = _rand(g, 2, hw * hw, C, dev=dev)
    tmb.reset_launches()
    with torch.no_grad():
        got = tmb.fused_block(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.float32, export=export)
        want = tmb.fused_block_reference(x, p, H=hw, W=hw, sr=sr, nh=nh, dtype=torch.float32,
                                         export=export)
    assert tmb.LAUNCHES["linear"] == 5 and tmb.LAUNCHES["attention"] == 1
    for a, b in zip(got if export else (got,), want if export else (want,)):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("dim", [18, 32, 40, 48])
@pytest.mark.parametrize("B,H,W", [(2, 7, 9), (1, 20, 45), (3, 13, 29), (2, 64, 64), (1, 1, 1)])
def test_k5_at_hrnet_widths(dev, dim, dtype, B, H, W):
    """K5 at HRNetV2's dims (hid = 4 dim, run at `padded_hid`), f32 and bf16: fc1 (its
    padded features 0), taps and the whole block against the plain versions, a rerun and
    every plan giving equal bits; one launch a wrapper call."""
    hid = 4 * dim
    g = torch.Generator().manual_seed(dim * H * W)
    p = _mlp_params(g, dim, hid, dim, dev)
    x = _rand(g, B, H * W, dim, dev=dev)
    f1 = (p["fc1_weight"].reshape(hid, dim).to(dtype), p["fc1_bias"], p["bn1_scale"],
          p["bn1_shift"])
    rest = (TM.tap_weights(p).to(dtype).contiguous(), p["dw_bias"], p["bn2_scale"],
            p["bn2_shift"], p["fc2_weight"].reshape(dim, hid).to(dtype), p["fc2_bias"],
            p["bn3_scale"], p["bn3_shift"])
    tol = {"fc1": F32_TOL, "taps": F32_TOL} if dtype == torch.float32 else \
        {"fc1": 2.0 ** -7, "taps": 1e-2}
    TM.reset_launches()
    with torch.no_grad():
        h = TM.mlp_fc1(x, *f1, dtype=dtype)
        assert h.shape == (B, H * W, TM.padded_hid(hid)) and not h[..., hid:].any()
        _close(h[..., :hid], TM.mlp_fc1_reference(x, *f1, dtype=dtype), tol["fc1"])
        out = TM.mlp_taps(h, *rest, H=H, W=W, dtype=dtype)
        _close(out, TM.mlp_taps_reference(h[..., :hid], *rest, H=H, W=W, dtype=dtype), tol["taps"])
        _close(TM.fused_mlp_dwbn(x, p, H=H, W=W, dtype=dtype),
               TM.fused_mlp_dwbn_reference(x, p, H=H, W=W, dtype=dtype), tol["taps"])
        assert TM.LAUNCHES == {"mlp_fc1": 2, "mlp_taps": 2}
        for plan in _fc1_plans_at(dim, hid, dtype, B * H * W):
            assert torch.equal(h, TM.mlp_fc1(x, *f1, dtype=dtype, plan=plan)), plan
        for tile in TM.taps_tiles(hid, dtype):
            for blocks in (1, 3, 132):
                assert torch.equal(out, TM.mlp_taps(h, *rest, H=H, W=W, dtype=dtype,
                                                    plan=(tile, blocks))), (tile, blocks)


def _fc1_plans_at(cin, hid, dtype, M):
    """bf16: 1, 2, 4, 8 warps walking 1 or 3 steps; f32: `chip_smoke.fc1_f32_plans`."""
    if dtype == BF16:
        return [(w, per) for w in (1, 2, 4, 8) for per in (1, 3) if TM.fc1_fits(cin, w, hid, dtype)]
    return fc1_f32_plans(TM, M, cin, hid)


# f32 fc1 (the 3xTF32 `wgmma` kernel): HRNetV2's widths, and cin 256 (w1 in 32-feature
# slices) at two hidden widths
FC1_F32_WIDTHS = [(18, 72), (32, 128), (40, 160), (48, 192), (256, 128), (256, 192)]


@pytest.mark.parametrize("cin,hid", FC1_F32_WIDTHS)
@pytest.mark.parametrize("M", [1, 15, 17, 1000, 8517])
def test_mlp_fc1_f32_every_plan_gives_equal_bits(dev, cin, hid, M):
    """f32 fc1 at token counts of one row, of a half tile less or more one and of no
    multiple of any tile: within F32_TOL of the plain version, its padded features 0, and
    a rerun and every plan (each tile of hidden features, 1, 3 and 132 blocks) give the
    same bits; one launch a call."""
    g = torch.Generator().manual_seed(M + cin + hid)
    x = _rand(g, 1, M, cin, dev=dev)
    f1 = (_rand(g, hid, cin, dev=dev, scale=cin ** -0.5), _rand(g, hid, dev=dev, scale=0.1),
          _rand(g, hid, dev=dev, scale=0.2, shift=1.0), _rand(g, hid, dev=dev, scale=0.1))
    f32 = torch.float32
    plans = _fc1_plans_at(cin, hid, f32, M)
    TM.reset_launches()
    with torch.no_grad():
        h = TM.mlp_fc1(x, *f1, dtype=f32)
        assert h.shape == (1, M, TM.padded_hid(hid)) and not h[..., hid:].any()
        _close(h[..., :hid], TM.mlp_fc1_reference(x, *f1, dtype=f32), F32_TOL)
        assert torch.equal(h, TM.mlp_fc1(x, *f1, dtype=f32))
        for plan in plans:
            assert torch.equal(h, TM.mlp_fc1(x, *f1, dtype=f32, plan=plan)), plan
    assert TM.LAUNCHES["mlp_fc1"] == 2 + len(plans)


def test_mlp_fc1_f32_is_one_kernel_and_one_count(dev):
    """An f32 call at the predict's width (cin 32, hid 128: nothing to pad) is one device
    kernel, the `fc1_wg_kernel`, and one LAUNCHES count."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(2)
    x = _rand(g, 4, 128 * 128, 32, dev=dev)
    f1 = (_rand(g, 128, 32, dev=dev, scale=32 ** -0.5), _rand(g, 128, dev=dev),
          _rand(g, 128, dev=dev), _rand(g, 128, dev=dev))
    want = TM.mlp_fc1(x, *f1, dtype=torch.float32)
    torch.cuda.synchronize()
    before = TM.LAUNCHES["mlp_fc1"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = TM.mlp_fc1(x, *f1, dtype=torch.float32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "fc1_wg_kernel" in kernels[0], kernels
    assert TM.LAUNCHES["mlp_fc1"] == before + 1 and torch.equal(got, want)


def test_mlp_fc1_f32_takes_x_4_bytes_off_at_cin_18_and_refuses_it_at_cin_32(dev):
    """Rows of 72 bytes come by bulk copies whatever x's 16-byte offset: x 4 bytes off at cin
    18 (a ragged head before every half tile's copy) gives the bits of the same values
    16-byte aligned; at cin 32 (rows by tensor map) such an x raises."""
    g = torch.Generator().manual_seed(3)
    f32 = torch.float32
    for cin, hid in ((18, 72), (32, 128)):
        f1 = (_rand(g, hid, cin, dev=dev), _rand(g, hid, dev=dev), _rand(g, hid, dev=dev),
              _rand(g, hid, dev=dev))
        for M in (1000, 17):
            odd = _rand(g, M * cin + 1, dev=dev)[1:].view(1, M, cin)   # contiguous, 4 bytes off
            if cin % 4:
                got = TM.mlp_fc1(odd, *f1, dtype=f32)
                assert torch.equal(got, TM.mlp_fc1(odd.clone(), *f1, dtype=f32))
                _close(got[..., :hid], TM.mlp_fc1_reference(odd, *f1, dtype=f32), F32_TOL)
            else:
                with pytest.raises(ValueError, match="aligned"):
                    TM.mlp_fc1(odd, *f1, dtype=f32)


def test_k5_fc1_blocks_per_sm_at_hrnet_widths(dev):
    from representationlearning_tpu_torch.ops import _build

    lib = _build.load_library("rssformer")
    for dim in (18, 32, 40, 48):
        for dtype in (torch.float32, BF16):
            hid, cinp = 4 * dim, -(-dim // 16) * 16
            warps = TM.fc1_plan(8 * 128 * 128, dim, hid, dtype)[0]
            assert lib.k5_fc1_blocks_per_sm(dim, cinp, TM.padded_hid(hid),
                                            int(dtype == torch.float32), warps) == \
                TM.fc1_blocks_per_sm(dim, warps, hid, dtype), (dim, dtype)


# ------------------------------------------------------------------ K6
def _isa_plans(T, C, nh):
    """Every (windows, warps, stages) that fits in shared memory, with one, two or
    more warps a (window, head) of a step, and one warp for all of them."""
    plans = {(w, min(TI.ISA_MAX_WARPS, f * w * nh), s) for w in (1, 2, 4)
             for s in (2, 3) for f in (1, 2, 8)} | {(2, 1, 2)}
    return sorted(p for p in plans if TI.isa_smem_bytes(T, C, nh, p[0], p[2]) <= TI.SMEM_LIMIT)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("NW,T,C,nh", [(1, 49, 32, 2), (133, 49, 32, 2), (7, 16, 36, 4),
                                       (5, 100, 18, 2), (3, 49, 64, 1), (2, 1, 8, 8)])
def test_isa_core_matches_plain(dev, dtype, NW, T, C, nh):
    """f32: the same products, sums of at most 100 terms in another order, `expf`
    against `torch.exp`: 1e-5. bf16: besides, a probability next to a rounding
    boundary may take the neighbouring bf16 value (2^-8 of a value below 1):
    1e-3. Window counts that no step of windows divides, head widths 9, 18 and 1;
    every plan and a second launch give the same bits, one launch a call."""
    g = torch.Generator().manual_seed(NW + T)
    q, k, v = (_rand(g, NW, T, C, dev=dev) for _ in range(3))
    q = q * (C // nh) ** -0.5
    before = TI.LAUNCHES["isa_core"]
    got = TI.isa_core(q, k, v, nh=nh, dtype=dtype)
    assert TI.LAUNCHES["isa_core"] == before + 1
    want = TI.isa_core_reference(q, k, v, nh=nh, dtype=dtype)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    _close(got, want, 1e-5 if dtype == torch.float32 else 1e-3)
    assert torch.equal(TI.isa_core(q, k, v, nh=nh, dtype=dtype), got)
    plans = _isa_plans(T, C, nh)
    for plan in plans:
        assert torch.equal(TI.isa_core(q, k, v, nh=nh, dtype=dtype, plan=plan), got), plan
    assert TI.LAUNCHES["isa_core"] == before + 2 + len(plans)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("C,nh", [(32, 2), (18, 2)])
def test_isa_core_gate_of_an_all_negative_window(dev, dtype, C, nh):
    """Small q >= 0 and k <= 0 put every entry of M_h a little below 0: the gate's
    max is the largest negative entry, never a padded 0, which would move the output
    by far more than the tolerance (head widths 16 and 9)."""
    g = torch.Generator().manual_seed(C)
    q = 0.2 * _rand(g, 6, 49, C, dev=dev).abs() * (C // nh) ** -0.5
    k, v = -0.4 * _rand(g, 6, 49, C, dev=dev).abs(), _rand(g, 6, 49, C, dev=dev)
    want = TI.isa_core_reference(q, k, v, nh=nh, dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    _close(TI.isa_core(q, k, v, nh=nh, dtype=dtype), want, tol)
    negative, moved = isa_trap_move(TI, q, k, want, nh, dtype)
    assert negative and moved > 10 * tol * max(1.0, want.abs().max().item())


def test_isa_attention_core_backward_is_the_plain_version(dev):
    g = torch.Generator().manual_seed(1)
    q, k, v = (_rand(g, 6, 49, 32, dev=dev).requires_grad_() for _ in range(3))
    cot = _rand(g, 6, 49, 32, dev=dev)
    before = TI.LAUNCHES["isa_core"]
    grads = torch.autograd.grad(TI.isa_attention_core(q, k, v, 2, BF16), (q, k, v), cot)
    assert TI.LAUNCHES["isa_core"] == before + 1     # the forward only
    want = torch.autograd.grad(TI.isa_core_reference(q, k, v, nh=2, dtype=BF16), (q, k, v), cot)
    for a, b in zip(grads, want):
        _close(a, b, 1e-5)


def test_isa_core_refuses_what_it_does_not_take(dev):
    q = torch.zeros(2, 49, 32, device=dev)
    with pytest.raises(ValueError, match="not contiguous"):
        TI.isa_core(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, nh=2)
    with pytest.raises(NotImplementedError, match="at most 128 tokens"):
        big = torch.zeros(1, 400, 64, device=dev)
        TI.isa_core(big, big, big, nh=2)
    with pytest.raises(NotImplementedError, match="shared memory"):
        wide = torch.zeros(1, 128, 2048, device=dev)
        TI.isa_core(wide, wide, wide, nh=32)
    with pytest.raises(ValueError, match="plan"):
        TI.isa_core(q, q, q, nh=2, plan=(1, 9, 2))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TI.isa_core(q, q, q, nh=2, dtype=torch.float16)


def test_hrnetfusion_runs_k5_and_k6(dev):
    """Two transformer blocks' worth of the model at full width: the module of
    stage 2 and one of stage 3, both flags on against both off."""
    from representationlearning_tpu_torch.models.hrnet import HighResolutionModule
    from representationlearning_tpu_torch.models.layers import init_weights

    g = torch.Generator().manual_seed(0)
    mods = []
    for fused in (True, False):
        with dev:
            m = HighResolutionModule(2, (32, 64), dtype=BF16, fused_mlp=fused,
                                     fused_attn=fused).eval()
        mods.append(m)
    init_weights(mods[0], g)
    with torch.no_grad():
        for bn in (b for b in mods[0].modules() if isinstance(b, torch.nn.BatchNorm2d)):
            bn.weight.mul_(0.5)
    mods[1].load_state_dict(mods[0].state_dict())
    xs = [_rand(g, 2, 32, 40, 36, dev=dev), _rand(g, 2, 64, 20, 18, dev=dev)]
    TM.reset_launches()
    TI.reset_launches()
    with torch.no_grad():
        got = mods[0](xs)
        assert TM.LAUNCHES == {"mlp_fc1": 1, "mlp_taps": 1} and TI.LAUNCHES == {"isa_core": 1}
        want = mods[1](xs)
    assert TM.LAUNCHES == {"mlp_fc1": 1, "mlp_taps": 1} and TI.LAUNCHES == {"isa_core": 1}
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        assert err <= 2e-2 * b.abs().max().item(), err


def test_fused_flags_launch_nothing_where_the_kernels_are_not_the_function(dev):
    """K5 folds running statistics and K6 drops no probability: a training call
    of `MlpDWBN(fused=True)`, and one of `Mhca(fused=True)` with live dropout,
    take the plain branches and launch nothing; the same modules in eval mode
    launch once each."""
    from representationlearning_tpu_torch.models.rssformer_modules import Mhca, MlpDWBN

    g = torch.Generator().manual_seed(0)
    with dev:
        mlp = MlpDWBN(32, 128, 32, dtype=BF16, fused=True)
        attn = Mhca(32, 2, dropout=0.5, fused=True, dtype=BF16)
    x, w = _rand(g, 2, 6 * 5, 32, dev=dev), _rand(g, 4, 49, 32, dev=dev)
    TM.reset_launches()
    TI.reset_launches()
    mlp.train()(x, 6, 5)
    attn.train()(w, w, w)
    assert sum(TM.LAUNCHES.values()) == 0 and sum(TI.LAUNCHES.values()) == 0
    with torch.no_grad():
        mlp.eval()(x, 6, 5)
        attn.eval()(w, w, w)
    assert TM.LAUNCHES == {"mlp_fc1": 1, "mlp_taps": 1} and TI.LAUNCHES == {"isa_core": 1}


# ------------------------------------------------------------------ the RML train step
def test_par_refine_at_the_rml_step_matches_plain(dev):
    """PAR at the RML step's refinement: 16 images of 160 x 160 and 2 * (8 + 1) = 18
    mask planes, K2 in `par` mode then ten launches of K3, against the plain
    versions on the same card; K3 alone equals its plain version bit for bit."""
    from representationlearning_tpu_torch.models import refine as TR

    g = torch.Generator().manual_seed(16)
    imgs = _image(g, 16, 160, 160, dev, border=True)
    masks = torch.rand((16, 18, 160, 160), generator=g).to(dev)
    k2, k3 = TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]
    got = TR.par_refine(imgs, masks, dilations=SCD_DILATIONS, num_iter=10)
    assert (TA.LAUNCHES["affinity"], TV.LAUNCHES["varm_propagate"]) == (k2 + 1, k3 + 10)
    ref = TA.affinity_reference(imgs, SCD_DILATIONS, "par", w1=0.3, w2=0.01)
    want = TV.varm_propagate_reference(masks, ref, SCD_DILATIONS, 10)
    assert got.shape == (16, 18, 160, 160) and bool(torch.isfinite(got).all())
    _close(got, want, 1e-4)   # K2's 2e-5 on the weights, carried through ten steps
    assert torch.equal(TV.varm_propagate(masks, ref, SCD_DILATIONS, 10), want)


def test_augment_cls_batch_on_the_card_matches_the_cpu(dev):
    """The classification chain at the RML step's shapes (16 raw 512 x 512 canvases
    to 320 x 320) on the card against the same decisions on the CPU."""
    from representationlearning_tpu_torch.data import device_transforms as TD

    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (16, 3, 512, 512), generator=g, dtype=torch.uint8)
    hw = torch.tensor([[375, 500]] * 8 + [[500, 333]] * 4 + [[120, 90]] * 4, dtype=torch.int32)
    cfg = TD.DeviceAugConfig(crop_size=320)
    dec = TD.sample_cls_decisions(16, cfg, g)
    want_img, want_box = TD.augment_cls_batch(raw, hw, dec, cfg)
    got_img, got_box = TD.augment_cls_batch(raw.to(dev), hw.to(dev),
                                            {k: v.to(dev) for k, v in dec.items()}, cfg)
    assert got_img.is_cuda and got_img.shape == (16, 3, 320, 320)
    assert (got_img.cpu() - want_img).abs().max().item() <= 1e-4
    assert torch.equal(got_box.cpu(), want_box)


def _rml_step_on_the_card(gen):
    """`make_rml_train_step` at a small size on the card: mit_b0 in bf16, the fused
    twin, two raw 160 x 160 canvases augmented to 128 x 128, CAM scales (1, 1.5)."""
    from representationlearning_tpu_torch.data.device_transforms import DeviceAugConfig
    from representationlearning_tpu_torch.models.rml import RMLModel
    from representationlearning_tpu_torch.models.tscd import share_parameters
    from representationlearning_tpu_torch.train import optim as TO
    from representationlearning_tpu_torch.train import rml as TRML
    from representationlearning_tpu_torch.train.state import TrainState

    model = RMLModel("mit_b0", 21, dtype=BF16, generator=gen)
    twin = share_parameters(RMLModel("mit_b0", 21, dtype=BF16, fused_blocks=True,
                                     collect_attns="none"), model).eval()
    cfg = TRML.RMLConfig(crop_size=128, cam_scales=(1.0, 1.5), max_present=4, cam_iters=-1)
    state = TrainState.create(model, TO.make_poly_warmup_adamw(
        model, 6e-5, 0.01, 10, 1000, param_labels=TO.tscd_param_labels))
    step = TRML.make_rml_train_step(model, cfg, cam_model=twin,
                                    aug_cfg=DeviceAugConfig(crop_size=128))
    batch = {"raw": torch.randint(0, 256, (2, 3, 160, 160), generator=gen, dtype=torch.uint8),
             "hw": torch.tensor([[150, 160], [120, 100]], dtype=torch.int32),
             "cls_label": torch.eye(20)[[2, 9]]}
    return model, state, step, batch


def test_rml_train_step_on_the_card(dev):
    """Two steps on the card: finite losses, the step count, one move of the neck's
    running statistics a step, every tensor on the card."""
    model, state, step, batch = _rml_step_on_the_card(torch.Generator().manual_seed(0))
    for i in range(2):
        state, met = step(state, batch, torch.Generator().manual_seed(i))
        assert set(met) == {"cls", "apml", "mfml", "ciml", "total"}
        assert all(v.is_cuda and bool(torch.isfinite(v)) for v in met.values())
    assert state.step == 2 and all(p.is_cuda for p in model.parameters())
    assert int(model.neck.fuse_conv[1].num_batches_tracked) == 2


def test_rml_train_step_launch_counts(dev):
    """A step launches K1 in the twin's four CAM forwards (scales 1 and 1.5 of the
    full and the 0.3-scale input), K2 once and K3 ten times, and nothing else."""
    _, state, step, batch = _rml_step_on_the_card(torch.Generator().manual_seed(1))
    mods = (tmb, TA, TV, TF, TM, TI)
    for mod in mods:
        mod.reset_launches()
    step(state, batch, torch.Generator().manual_seed(0))
    counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    n = 4   # forwards of 2 x 2 images, 8 blocks each, 6 of them with sr > 1
    assert counts == {"ln_stats": n * (16 + 6), "linear": n * 40, "sr_conv": n * 6,
                      "attention": n * 8, "dwconv_gelu": n * 8, "affinity": 1,
                      "varm_propagate": 10, "flash_fwd": 0, "flash_bwd": 0, "mlp_fc1": 0,
                      "mlp_taps": 0, "isa_core": 0}


def _rssformer_on_the_card(fused_attn=False, fused_mlp=False, initial=None):
    """`HRNetFusion("hrnetv2_w32", 7, bf16)` on the card (K5 takes w32's hid 128),
    its optimiser state and train step, and a batch of 2 x 64 x 64 with masks
    in [-1, 7)."""
    from representationlearning_tpu_torch.models.rssformer import HRNetFusion
    from representationlearning_tpu_torch.train import rssformer as TRS

    model = HRNetFusion("hrnetv2_w32", 7, dtype=BF16, fused_attn=fused_attn, fused_mlp=fused_mlp,
                        generator=torch.Generator().manual_seed(0))
    if initial is not None:
        model.load_state_dict(initial)
    cfg = TRS.RSSFormerTrainConfig()
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(2, 3, 64, 64, generator=gen),
             "mask": torch.randint(-1, 7, (2, 64, 64), generator=gen)}
    state = TRS.create_rssformer_state(model, cfg)
    return model, state, TRS.make_rssformer_train_step(model, cfg), batch


def test_rssformer_train_step_on_the_card(dev):
    """Two steps: finite losses on the card, no hand-written kernel, the step count,
    the neck's statistics moved twice; the first step again with `fused_attn` on K6
    (8 launches, forward only) within 2e-2 of the loss."""
    model, state, step, batch = _rssformer_on_the_card()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    mods = (tmb, TA, TV, TF, TM, TI)
    losses = []
    for _ in range(2):
        for mod in mods:
            mod.reset_launches()
        state, met = step(state, batch)
        assert set(met) == {"fc_loss", "total"}
        assert all(v.is_cuda and bool(torch.isfinite(v)) for v in met.values())
        assert not any(v for mod in mods for v in mod.LAUNCHES.values())
        losses.append(float(met["total"]))
    assert state.step == 2 and int(model.neck.fuse_conv[1].num_batches_tracked) == 2
    _, f_state, f_step, _ = _rssformer_on_the_card(fused_attn=True, initial=initial)
    for mod in mods:
        mod.reset_launches()
    _, f_met = f_step(f_state, batch)
    counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    assert counts == {"isa_core": 8}
    assert abs(float(f_met["total"]) - losses[0]) <= 2e-2 * abs(losses[0]) + 2e-3


def test_rssformer_evaluate_on_k5(dev):
    """`evaluate` with `fused_mlp=True` runs K5 8 + 8 a forward; its probabilities
    are within 3e-2 of the convolutions' (`chip_smoke.RSS_TOL`)."""
    from chip_smoke import RSS_TOL, calm, set_rss_flags
    from representationlearning_tpu_torch.train import rssformer as TRS

    model, _, _, batch = _rssformer_on_the_card(fused_mlp=True)
    calm(torch, model, torch.Generator().manual_seed(2))
    TM.reset_launches()
    scores = TRS.evaluate(model, [(batch["image"], batch["mask"])], 7)
    assert TM.LAUNCHES == {"mlp_fc1": 8, "mlp_taps": 8} and 0.0 <= scores["pAcc"] <= 1.0
    step = TRS.make_rssformer_eval_step(model)
    fused = step(batch["image"].to(dev))
    set_rss_flags(model, False, False)
    plain = step(batch["image"].to(dev))
    assert (fused - plain).abs().max().item() <= RSS_TOL


def _calm_resnet(net, seed):
    """FrozenBatchNorm scales around 0.5 and noise on every statistic, so that
    sixteen bottlenecks keep the stream of order 1 at random weights."""
    from representationlearning_tpu_torch.models.resnet import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.mul_(0.5).add_(_rand(g, *m.weight.shape, dev=m.weight.device, scale=0.05))
                m.bias.add_(_rand(g, *m.bias.shape, dev=m.bias.device, scale=0.1))
                m.running_mean.add_(_rand(g, *m.running_mean.shape, dev=m.bias.device,
                                          scale=0.1))
    return net


def test_wavecam_net_bf16_matches_f32(dev):
    """The bench's `Net(dtype=bf16)` against the same weights in f32: the CAMs of a
    flip pair within 2e-2 of their largest magnitude, f32 out of both."""
    from representationlearning_tpu_torch.models.resnet import Net

    net = _calm_resnet(Net(16, 20, dtype=BF16, generator=torch.Generator().manual_seed(0),
                           device=dev), 1).eval()
    f32 = Net(16, 20, device=dev).eval()
    f32.load_state_dict(net.state_dict())
    x = _rand(torch.Generator().manual_seed(2), 2, 3, 96, 128, dev=dev)
    with torch.no_grad():
        got, want = net.cam(torch.cat([x, x.flip(-1)])), f32.cam(torch.cat([x, x.flip(-1)]))
    assert got.dtype == want.dtype == torch.float32 and got.shape == (4, 20, 6, 8)
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


def test_transition_matrix_columns_sum_to_one(dev):
    """`propagate_to_edge` on the card: every column of the transition matrix sums
    to 1 within 1e-3, and the walk equals the CPU's within 1e-4 of its largest."""
    from representationlearning_tpu_torch.wsss.indexing import propagate_to_edge

    g = torch.Generator().manual_seed(3)
    x, edge = torch.rand(3, 24, 32, generator=g), torch.rand(24, 32, generator=g) ** 4
    out = {}
    got = propagate_to_edge(x.to(dev), edge.to(dev), 5, 10.0, 8, out=out)
    assert out["trans"].device.type == "cuda" and out["trans"].shape == (768, 768)
    assert (out["trans"].sum(0) - 1).abs().max().item() < 1e-3
    want = propagate_to_edge(x, edge, 5, 10.0, 8)
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_crf_label_grid_vs_native_on_the_card(dev):
    """The CRF label pass with the bilateral grid on the card agrees with the host
    lattice on more than 99% of the pixels, and with the grid on the CPU on more
    than 99.5%."""
    import numpy as np

    from representationlearning_tpu_torch.ops.crf import crf_inference_label

    rng = np.random.default_rng(0)
    H, W = 64, 96
    img = np.zeros((3, H, W), np.float32)
    lab = np.zeros((H, W), np.int64)
    yy, xx = np.mgrid[0:H, 0:W]
    for c in range(1, 4):
        cy, cx, r = rng.integers(10, H - 10), rng.integers(10, W - 10), rng.integers(8, 20)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        lab[m] = c
        img[:, m] = (rng.random(3) * 200 + 30)[:, None]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.float32)
    noisy = torch.from_numpy(np.where(rng.random((H, W)) < 0.08, rng.integers(0, 4, (H, W)), lab))
    im = torch.from_numpy(img)
    grid = crf_inference_label(im.to(dev), noisy.to(dev), n_labels=4, method="grid")
    native = crf_inference_label(im.to(dev), noisy.to(dev), n_labels=4, method="native")
    assert grid.device.type == native.device.type == "cuda"
    assert (grid == native).float().mean().item() > 0.99
    cpu = crf_inference_label(im, noisy, n_labels=4, method="grid")
    assert (grid.cpu() == cpu).float().mean().item() > 0.995


def test_drfl_card_against_cpu(dev):
    """DRFL at 64², one ViT layer, the same weights and host-drawn dropout masks:
    the eval forward's five outputs, one train step's three losses and each
    top-level module's gradient norm, card against CPU, within their bounds
    (chip_smoke.py phase 7e(b), ``drfl_agreement``)."""
    failed = [msg for ok, msg in drfl_agreement(drfl_card_vs_cpu(torch, dev, 3)) if not ok]
    assert not failed, failed
