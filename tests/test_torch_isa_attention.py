"""Kernel K6 (the window-attention core with the DAL gate) of the PyTorch port
against the JAX package: the plain version against `_core_pallas` in interpret
mode and `_core_reference` (as `tests/test_pallas_isa.py:32-41` runs them), and
the gradients of the `autograd.Function` against `jax.grad` of
`isa_attention_core` (`:44-58`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import isa_trap_move
from representationlearning_tpu.ops.pallas import isa_attention as ji
from representationlearning_tpu_torch.ops import isa_attention as ti

torch.set_num_threads(2)

# f32: the same products; sums over hd <= 16 and T <= 49 terms in another order
F32_ATOL = 1e-5
# gradients: the JAX package's own bound (tests/test_pallas_isa.py:58)
GRAD_TOL = 1e-4
# the predict path's window, head widths 16, 9, 32 and 20, and the card kernel's
# edges: one token and head width 1, 100 tokens, head width 64
SHAPES = [(12, 49, 32, 2), (7, 49, 64, 4), (3, 16, 32, 1), (5, 49, 18, 2), (1, 25, 40, 2),
          (3, 1, 8, 8), (2, 100, 18, 2), (2, 49, 64, 1)]


def _qkv(NW, T, C, nh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((NW, T, C)).astype(np.float32) for _ in range(3))
    return q * (C // nh) ** -0.5, k, v


@pytest.mark.parametrize("NW,T,C,nh", SHAPES)
def test_isa_core_reference_matches_jax(NW, T, C, nh):
    q, k, v = _qkv(NW, T, C, nh)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(ji._core_reference(jq, jk, jv, nh=nh))
    wantk = np.asarray(ji._core_pallas(jq, jk, jv, nh=nh, dtype=jnp.float32, chunk=8,
                                       interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ti.isa_core_reference(tq, tk, tv, nh=nh)
    assert got.shape == (NW, T, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), wantk, atol=F32_ATOL)
    # CPU tensors: the wrapper and the differentiable entry are the plain version
    ti.reset_launches()
    assert torch.equal(ti.isa_core(tq, tk, tv, nh=nh), got)
    assert torch.equal(ti.isa_attention_core(tq, tk, tv, nh), got)
    assert ti.LAUNCHES == {"isa_core": 0}


def test_isa_core_bf16_matches_jax_bf16():
    """bf16 operands (q, k, the probabilities, v), f32 sums: both sides round the
    same f32 values; a probability next to a rounding boundary may land on the
    neighbouring bf16 value (2^-8 of a value below 1): 1e-3 of the largest
    output."""
    q, k, v = _qkv(9, 49, 32, 2, seed=2)
    want = np.asarray(ji._core_reference(*(jnp.asarray(a) for a in (q, k, v)), nh=2,
                                         dtype=jnp.bfloat16))
    got = ti.isa_core_reference(*(torch.from_numpy(a) for a in (q, k, v)), nh=2,
                                dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_isa_attention_core_grads_match_jax(dtype):
    q, k, v = _qkv(5, 49, 32, 2, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(a, b, c):
        return (ji.isa_attention_core(a, b, c, 2, jdt) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ti.isa_attention_core(tq, tk, tv, 2, tdt).square().sum().backward()
    # bf16: the casts pass the gradient straight through on both sides, and the
    # forward values differ by bf16 flips: 2e-2 of the largest entry
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        tol = GRAD_TOL if dtype == "float32" else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(got.numpy(), w, atol=tol, rtol=GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,nh", [(32, 2), (18, 2)])
def test_isa_core_gate_of_an_all_negative_window_matches_jax(dtype, C, nh):
    """Small q >= 0 and k <= 0: every entry of M_h lies a little below 0, so the
    gate's max is the largest negative entry, and a max that let a padded 0 in
    would move the output by far more than the tolerance."""
    q, k, v = _qkv(4, 49, C, nh, seed=5)
    q, k = 0.2 * np.abs(q), -0.4 * np.abs(k)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ji._core_reference(*(jnp.asarray(a) for a in (q, k, v)), nh=nh, dtype=jdt))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ti.isa_core_reference(tq, tk, tv, nh=nh, dtype=tdt)
    tol = F32_ATOL if dtype == "float32" else 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    negative, moved = isa_trap_move(ti, tq, tk, got, nh, tdt)
    assert negative and moved > 10 * tol


@pytest.mark.parametrize("NW,T,C,nh,dtype,want", [
    # the predict path: 1444 windows of 49 x 32, 2 heads; one window a step, two
    # warps a head (four 16-row tiles under bf16, two 32-row tiles under f32), two
    # stages: four blocks an SM
    (1444, 49, 32, 2, torch.bfloat16, (1, 4, 2)),
    (1444, 49, 32, 2, torch.float32, (1, 4, 2)),
    (1, 49, 32, 2, torch.bfloat16, (1, 4, 2)),
    # one row tile: one warp a head
    (2, 1, 8, 8, torch.bfloat16, (1, 8, 2)),
    (7, 16, 36, 4, torch.bfloat16, (1, 4, 2)),
    (37, 16, 32, 2, torch.bfloat16, (1, 2, 2)),
    (5, 32, 32, 2, torch.float32, (1, 2, 2)),
    # at most ISA_MAX_WARPS
    (7, 49, 36, 4, torch.bfloat16, (1, 8, 2)),
    (7, 49, 64, 8, torch.bfloat16, (1, 8, 2)),
    (5, 100, 18, 2, torch.bfloat16, (1, 4, 2)),
    (3, 49, 64, 1, torch.bfloat16, (1, 2, 2)),
])
def test_isa_plan(NW, T, C, nh, dtype, want):
    plan = ti.isa_plan(NW, T, C, nh, dtype)
    assert plan == want
    windows, warps, stages = plan
    assert 1 <= warps <= ti.ISA_MAX_WARPS and stages in (2, 3)
    assert ti.isa_smem_bytes(T, C, nh, windows, stages) <= ti.SMEM_LIMIT


def test_isa_pitch_and_shared_memory():
    """Rows 2t and 2t + 1 of a column fall in 32 different banks: P % 32 == 4."""
    for C in (8, 18, 32, 36, 64, 100):
        P = ti.isa_pitch(C)
        assert P >= C and P % 32 == 4 and P - C < 32
    # the predict path's step: 2 windows of 49 x 36 floats, q, k, v, two stages, 4 gates
    assert ti.isa_smem_bytes(49, 32, 2, 2, 2) == 4 * (2 * 3 * 2 * 49 * 36 + 4)


@pytest.mark.parametrize("shape,match", [((1, 129, 32, 2), "at most 128 tokens"),
                                         ((1, 49, 130, 2), "head width 64"),
                                         ((1, 128, 2048, 32), "shared memory")])
def test_isa_plan_refuses_what_the_kernel_does_not_take(shape, match):
    with pytest.raises(NotImplementedError, match=match):
        ti.isa_plan(*shape)


def test_backward_is_autograd_through_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 16, 24, 3, seed=4))
    cot = torch.randn(4, 16, 24, generator=torch.Generator().manual_seed(0))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ga = torch.autograd.grad(ti.isa_attention_core(*a, 3), a, cot)
    gb = torch.autograd.grad(ti.isa_core_reference(*b, nh=3), b, cot)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_isa_core_refuses_heads_that_do_not_divide():
    q = torch.zeros(2, 9, 10)
    with pytest.raises(ValueError, match="multiple of nh"):
        ti.isa_core(q, q, q, nh=3)
