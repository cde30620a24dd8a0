"""K2's plain version (`affinity_reference`) against the JAX package: the Pallas
kernel in interpret mode and the XLA composition over the neighbour tensor, on
the same numpy-seeded images (NHWC there, NCHW here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.models import refine as JR
from representationlearning_tpu.ops.pallas.affinity import _pos_softmax as j_pos_softmax
from representationlearning_tpu.ops.pallas.affinity import affinity_pallas
from representationlearning_tpu_torch.ops import affinity as TA

torch.set_num_threads(2)

# the bound of the JAX package's own kernel test (tests/test_pallas_attention.py:256):
# the K-axis sums run in another order on each side
TOL = dict(atol=2e-5, rtol=1e-4)
SCD_DILATIONS = (1, 2, 4, 8, 12, 24)


def _images(kind: str, shape, seed: int) -> np.ndarray:
    """(B, H, W, 3) f32 in [0, 255]. "border": a constant frame around a random
    centre, as a zero-padded crop looks after denormalisation."""
    B, H, W = shape
    img = (np.random.default_rng(seed).random((B, H, W, 3)) * 255.0).astype(np.float32)
    if kind == "border":
        frame = np.broadcast_to(np.array([123.675, 116.28, 103.53], np.float32), img.shape)
        inside = np.zeros((B, H, W, 1), bool)
        inside[:, H // 4: H - H // 4, W // 3: W - W // 5] = True
        img = np.where(inside, img, frame)
    return img


def _xla_affinity(imgs, dil, mode, w1, w2):
    """The composition of `models/refine.py:133-146,163-174,190-195`, channel-first."""
    nb = JR.dilated_neighbors(imgs, dil)
    center = imgs[:, :, :, None, :]
    a = jnp.abs(nb - center) / (JR._unbiased_std(nb, 3) + 1e-8)
    a = a * 4 if mode == "varm" else a / w1
    ref = jax.nn.softmax((-(a ** 2)).mean(-1, keepdims=True), axis=3)
    if mode == "par":
        pos = JR._pos_tensor(dil)
        pos_aff = -((pos / (jnp.std(pos, ddof=1) + 1e-8)) / w1) ** 2
        ref = ref + w2 * jax.nn.softmax(pos_aff)[None, None, None, :, None]
    elif mode == "varm":
        t1 = jnp.concatenate([nb[:, 1:], nb[:, -1:]], axis=1)
        t2 = jnp.concatenate([nb[:, :, 1:], nb[:, :, -1:]], axis=2)
        temp = ((nb - t1) ** 2 + (nb - t2) ** 2).mean(-1, keepdims=True)
        ref = ref - w2 * jax.nn.softmax(temp, axis=3)
    return np.asarray(ref[..., 0].transpose(0, 3, 1, 2))


CASES = [("random", (2, 16, 16), (1, 2, 4)), ("random", (1, 32, 32), SCD_DILATIONS),
         ("random", (2, 20, 28), (1, 2, 4)), ("border", (2, 24, 32), SCD_DILATIONS)]


@pytest.mark.parametrize("mode", ["par", "pamr", "varm"])
@pytest.mark.parametrize("kind,shape,dil", CASES)
def test_affinity_reference_matches_jax(kind, shape, dil, mode):
    img = _images(kind, shape, seed=1)
    got = TA.affinity(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), dil, mode,
                      w1=0.3, w2=0.01)
    assert TA.LAUNCHES["affinity"] == 0  # a CPU tensor runs the plain version
    assert got.shape == (shape[0], 8 * len(dil), shape[1], shape[2])
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _xla_affinity(jnp.asarray(img), dil, mode, 0.3, 0.01),
                               **TOL)
    pallas = affinity_pallas(jnp.asarray(img), dil, mode, w1=0.3, w2=0.01, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("mode", ["pamr", "varm"])
def test_flat_region_gives_a_uniform_softmax(mode):
    """Deep inside a constant frame every neighbour equals the centre: the
    standard deviation is 0, every difference exactly 0, the softmax uniform."""
    img = _images("border", (1, 64, 64), seed=2)
    dil = (1, 2, 4)
    got = TA.affinity_reference(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), dil, mode)
    K = 8 * len(dil)
    want = 1.0 / K if mode == "pamr" else (1.0 - 0.01) / K
    np.testing.assert_allclose(got[0, :, :8, :8].numpy(), want, rtol=1e-6)


def test_pos_softmax_is_the_jax_constant():
    for dil in ((1, 2, 4), SCD_DILATIONS):
        assert TA._pos_softmax(dil, 0.3) == j_pos_softmax(dil, 0.3)


def test_affinity_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        TA.affinity(torch.zeros(1, 3, 8, 8), (1,), "nope")


# The kernel's plans, checked on the CPU
D6 = SCD_DILATIONS
SHAPES = [(8, 160, 160), (8, 256, 256), (2, 13, 37), (2, 33, 40), (2, 9, 9), (1, 1, 1)]


@pytest.mark.parametrize("mode", ["par", "pamr", "varm"])
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_affinity_plans_cover_every_pixel_once(B, H, W, mode):
    from chip_smoke import affinity_plans

    plan = TA.affinity_plan(B, H, W, D6, mode)
    assert plan == TA.affinity_plan(B, H, W, tuple(D6), mode)  # a function of the shapes
    plans = affinity_plans(TA, H, W, D6, mode)
    assert plan in plans
    for plan in plans:
        # the kernel's grid: block (i, j, b) makes image b's rows [rows * j, rows * (j + 1))
        # and columns [32 * i, 32 * (i + 1)), within the image
        gx, gy, gb = -(-W // 32), -(-H // plan[0]), B
        seen = np.zeros((B, H, W), np.int32)
        for b in range(gb):
            for j in range(gy):
                for i in range(gx):
                    seen[b, plan[0] * j:plan[0] * (j + 1), 32 * i:32 * (i + 1)] += 1
        assert (seen == 1).all(), plan


@pytest.mark.parametrize("mode", ["par", "varm"])
def test_affinity_plan_on_a_cpu_tensor_runs_the_plain_version(mode):
    img = _images("random", (2, 20, 28), seed=5)
    want = _xla_affinity(jnp.asarray(img), (1, 2, 4), mode, 0.3, 0.01)
    for plan in ((8, 6), (4, 16)):
        got = TA.affinity(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), (1, 2, 4), mode,
                          w1=0.3, w2=0.01, plan=plan)
        assert TA.LAUNCHES["affinity"] == 0
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("plan,dil,hw", [((3, 6), D6, 16), ((8, 6), tuple(range(1, 8)), 16),
                                         ((8, 6), (1, 30), 64), ((8,), D6, 16),
                                         (None, D6, 16)])
def test_affinity_refuses_a_plan_the_kernel_does_not_take_on_the_cpu_too(plan, dil, hw):
    with pytest.raises(ValueError, match="plan"):
        TA.affinity(torch.zeros(1, 3, hw, hw), dil, "varm", plan=plan or "fast")


def test_affinity_sixteen_dilation_kernel_takes_what_the_six_do_not():
    assert TA.affinity_plan(1, 64, 64, (1, 30), "varm") == (4, 16)
    assert TA.affinity_plan(1, 16, 16, tuple(range(1, 9)), "par") == (4, 16)


@pytest.mark.parametrize("mode", ["par", "varm"])
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_affinity_blocks_per_sm_estimate_stays_within_an_sm(B, H, W, mode):
    for (rows, held), regs in TA.AFFINITY_KERNELS.items():
        if not TA.affinity_takes(H, W, D6, mode, rows, held):
            continue
        smem = TA.affinity_smem_bytes(H, W, D6, mode, rows, held)
        n = TA.affinity_blocks_per_sm(rows, held, mode, smem)
        threads = 32 * rows
        assert n >= 1 and smem <= TA.SMEM_LIMIT
        assert n * (smem + 1024) <= TA.SMEM_PER_SM, (rows, held)
        assert n * threads * -(-regs[mode == "varm"] // 8) * 8 <= TA.REGS_PER_SM, (rows, held)
        assert n * threads <= 2048
