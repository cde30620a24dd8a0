"""K3's plain version (`varm_propagate_reference`) against the JAX package: the
XLA loop `_propagate` and the Pallas kernel in interpret mode, on the same
numpy-seeded masks and weights (NHWC there, NCHW here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models.refine import _propagate
from representationlearning_tpu.ops.pallas.varm import varm_propagate_pallas
from representationlearning_tpu_torch.ops import varm as TV

torch.set_num_threads(2)

# the JAX package's own bound for this kernel (tests/test_pallas_attention.py:59):
# the same products summed in the same order, so in fact the results are equal
ATOL = 1e-6


def _inputs(B, H, W, C, dil, seed=0):
    rng = np.random.default_rng(seed)
    K = 8 * len(dil)
    masks = rng.random((B, H, W, C)).astype(np.float32)
    ref = rng.random((B, H, W, K, 1)).astype(np.float32)
    return masks, ref / ref.sum(3, keepdims=True)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("layout", ["channel_first", "kept_axis"])
@pytest.mark.parametrize("B,H,W,C,dil,num_iter", [
    (2, 16, 16, 5, (1, 2, 4), 3), (1, 12, 20, 1, (1, 2, 4, 8, 12, 24), 3),
    (2, 16, 16, 7, (1, 2), 0), (1, 16, 24, 18, (1, 4), 2)])
def test_varm_reference_matches_jax(B, H, W, C, dil, num_iter, layout):
    masks, ref = _inputs(B, H, W, C, dil)
    ref_cf = _nchw(ref[..., 0])                                   # (B, K, H, W)
    t_ref = ref_cf if layout == "channel_first" else ref_cf[:, :, None]
    got = TV.varm_propagate(_nchw(masks), t_ref, dil, num_iter)
    assert TV.LAUNCHES["varm_propagate"] == 0  # a CPU tensor runs the plain version
    got = got.numpy().transpose(0, 2, 3, 1)
    if num_iter == 0:
        np.testing.assert_array_equal(got, masks)
        return
    want = np.asarray(_propagate(jnp.asarray(masks), jnp.asarray(ref), dil, num_iter))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # C = 5, 7, 1, 18 with channel_block 4: C need not divide the block
    pallas = varm_propagate_pallas(jnp.asarray(masks), jnp.asarray(ref), dil, num_iter,
                                   channel_block=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)


def test_varm_reference_takes_the_pallas_channel_first_weights():
    masks, ref = _inputs(2, 16, 16, 5, (1, 2, 4), seed=3)
    ref_cf = np.ascontiguousarray(ref[..., 0].transpose(0, 3, 1, 2))
    want = varm_propagate_pallas(jnp.asarray(masks), jnp.asarray(ref_cf), (1, 2, 4), 3,
                                 interpret=True)
    got = TV.varm_propagate_reference(_nchw(masks), torch.from_numpy(ref_cf), (1, 2, 4), 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=ATOL)


def test_varm_refuses_weights_of_another_tap_count():
    with pytest.raises(ValueError, match="K = 16"):
        TV.varm_propagate(torch.zeros(1, 2, 8, 8), torch.zeros(1, 8, 8, 8), (1, 2), 1)
    with pytest.raises(ValueError, match=r"\(B, K, 1, H, W\)"):
        TV.varm_propagate(torch.zeros(1, 2, 8, 8), torch.zeros(1, 8, 2, 8, 8), (1,), 1)


# The kernel's plans, checked on the CPU: the pseudo-label call's planes (18 and 42 mask
# planes at 160^2), a larger plane, and the edges (a plane shorter than the halo, 1 x 1)
D6 = (1, 2, 4, 8, 12, 24)
PLANES = [(8, 18, 160, 160), (8, 42, 160, 160), (8, 18, 256, 256), (2, 5, 13, 37),
          (2, 18, 33, 40), (2, 3, 9, 9), (1, 1, 1, 1)]


@pytest.mark.parametrize("B,C,H,W", PLANES)
def test_varm_plans_walk_every_pixel_of_every_plane_once(B, C, H, W):
    from chip_smoke import varm_plans

    plan = TV.varm_plan(B, C, H, W, D6)
    assert plan == TV.varm_plan(B, C, H, W, tuple(D6))  # a function of the shapes
    plans = varm_plans(TV, B, C, H, W, D6)
    assert plan in plans
    for plan in plans:
        tile_rows = plan[0]
        seen = np.zeros((B, C, H, W), np.int32)
        for g in range(min(plan[2], TV.varm_units(B, C, H, W, *plan[:2]))):
            for b, c0, n, ty, tx in TV.varm_steps(B, C, H, W, plan, g):
                assert n >= 1
                seen[b, c0:c0 + n, ty * tile_rows:(ty + 1) * tile_rows, tx * 32:(tx + 1) * 32] += 1
        assert (seen == 1).all(), plan


def test_varm_plan_on_a_cpu_tensor_runs_the_plain_version():
    masks, ref = _inputs(2, 16, 24, 5, D6, seed=4)
    want = np.asarray(_propagate(jnp.asarray(masks), jnp.asarray(ref), D6, 3))
    for plan in ((32, 2, 132), (8, 1, 3)):
        got = TV.varm_propagate(_nchw(masks), _nchw(ref[..., 0]), D6, 3, plan=plan)
        assert TV.LAUNCHES["varm_propagate"] == 0
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=ATOL)


@pytest.mark.parametrize("plan,dil,hw", [((24, 2, 4), D6, 16), ((32, 2, 0), D6, 16),
                                         ((32, 2, 4), tuple(range(1, 8)), 16),
                                         ((32, 2, 4), (1, 40), 100), ((32, 2), D6, 16),
                                         ("fast", D6, 16)])
def test_varm_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too(plan, dil, hw):
    masks = torch.zeros(1, 2, hw, hw)
    ref = torch.zeros(1, 8 * len(dil), hw, hw)
    with pytest.raises(ValueError, match="plan"):
        TV.varm_propagate(masks, ref, dil, 1, plan=plan)


def test_varm_one_pixel_kernel_takes_what_the_two_pixel_kernels_do_not():
    # sixteen dilations, and a halo of 40 on a 100^2 plane
    assert TV.varm_plan(1, 2, 100, 100, (1, 40))[:2] == (8, 1)
    assert TV.varm_plan(1, 2, 16, 16, tuple(range(1, 17)))[:2] == (8, 1)
    assert TV.check_varm_plan((8, 1, 3), 100, 100, (1, 40)) == (8, 1, 3)


@pytest.mark.parametrize("B,C,H,W", PLANES)
def test_varm_blocks_per_sm_estimate_stays_within_an_sm(B, C, H, W):
    for key, (threads, _, regs) in TV.VARM_KERNELS.items():
        if not TV.varm_takes(H, W, D6, *key):
            continue
        smem = TV.varm_geometry(H, W, D6, *key)[2]
        n = TV.varm_blocks_per_sm(*key, smem)
        assert n >= 1 and smem <= TV.SMEM_LIMIT
        assert n * (smem + 1024) <= TV.SMEM_PER_SM, key
        assert n * threads * -(-regs // 8) * 8 <= TV.REGS_PER_SM, key
        assert n * threads <= 2048, key
