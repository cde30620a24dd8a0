"""`infer/sliding.py::sharded_sliding_window_predict` of the port on 2 and 4 gloo
ranks (`parallel/launch.py`) against the JAX package's on a (1, n) mesh of the
conftest's virtual CPU devices (`tests/test_tta_sliding.py:57-90`'s models and
sizes, ragged ones included), and against the port's single-device path on the
same padding (`pad_for_sliding(..., row_multiple=n)`).

Tolerances: against JAX, f32 (1e-5 relative and 1e-6 absolute, as JAX's own test
holds its two paths, the absolute one times the largest magnitude where that is
above 1: the ragged cases' model sums 768 products into outputs of about 30, and
the two libraries' matrix products round differently); against the port's single-device path, equal bits with a
model whose every output element is computed the same way whatever the batch of
windows it comes in (`dp_common.pool_mix`): the sharded path hands the partial
sums of a strip up before the next rank adds its own, in the single-device
order. The 3 x 3 convolution's own result may depend on the batch it runs in, so
it is held to 1e-6 there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dp_common
from representationlearning_tpu.infer.sliding import \
    sharded_sliding_window_predict as j_sharded
from representationlearning_tpu.parallel import mesh as JM
from representationlearning_tpu_torch.infer import sliding as S
from representationlearning_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)
RNG = np.random.default_rng(3)
N_OUT, LIN_OUT = 4, 3
LIN_W = RNG.standard_normal((16 * 16 * 3, LIN_OUT)).astype(np.float32)
# (name, H, W, window, stride, model): tests/test_tta_sliding.py's
CASES = [(f"mean-{w}-{s}", 128, 48, w, s, "conv_mean") for w, s in ((16, 8), (16, 16), (24, 8))]
CASES += [(f"linear-{h}x{w}", h, w, 16, 8, "linear") for h, w in ((70, 33), (100, 16), (64, 40))]
CASES += [(f"pool-{h}x{w}-{wi}-{s}", h, w, wi, s, "pool_mix")
          for h, w, wi, s in ((128, 48, 16, 8), (70, 33, 24, 8), (60, 48, 16, 16), (100, 16, 16, 8))]
IMAGES = {name: RNG.standard_normal((3, h, w)).astype(np.float32) for name, h, w, *_ in CASES}


def _n_out(kind):
    return LIN_OUT if kind == "linear" else (3 if kind == "pool_mix" else N_OUT)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    n = request.param
    cases = [(name, IMAGES[name], wi, s, _n_out(kind), kind, LIN_W)
             for name, _, _, wi, s, kind in CASES]
    return n, spawn_ranks(dp_common.sliding_rank, n, (cases,))


def _jax_model(kind, window):
    if kind == "conv_mean":
        k = jnp.asarray(np.ones((3, 3, 3, N_OUT), np.float32) / 9.0)
        return lambda t: jax.lax.conv_general_dilated(
            t, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    w = jnp.asarray(LIN_W)

    def fn(tiles):
        B = tiles.shape[0]
        v = (tiles.reshape(B, -1) @ w).reshape(B, 1, 1, LIN_OUT)
        return jnp.broadcast_to(v, (B, window, window, LIN_OUT))
    return fn


def _port_model(kind, window):
    return {"conv_mean": lambda: dp_common.conv_mean(N_OUT), "pool_mix": lambda: dp_common.pool_mix,
            "linear": lambda: dp_common.linear_tile(LIN_W, window, LIN_OUT)}[kind]()


@pytest.mark.parametrize("case", [c for c in CASES if c[5] != "pool_mix"], ids=lambda c: c[0])
def test_sharded_matches_jax(devices8, ranks, case):
    n, outs = ranks
    name, H, W, window, stride, kind = case
    mesh = JM.make_mesh(n_data=1, n_model=n, devices=devices8[:n])
    img = jnp.asarray(IMAGES[name].transpose(1, 2, 0))
    want = np.asarray(jax.jit(lambda im: j_sharded(_jax_model(kind, window), im, mesh, window,
                                                   stride, _n_out(kind)))(img))
    want = want.transpose(2, 0, 1)
    for r in range(n):
        got = dict((c, o) for c, o, _ in outs[r])[name]
        assert got.shape == (_n_out(kind), H, W)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()), err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sharded_matches_single_device_on_the_same_padding(ranks, case):
    n, outs = ranks
    name, H, W, window, stride, kind = case
    padded, _ = S.pad_for_sliding(torch.from_numpy(IMAGES[name]), window, stride, row_multiple=n)
    single = S.sliding_window_predict(_port_model(kind, window), padded, window, stride,
                                      _n_out(kind))[:, :H, :W]
    for r in range(n):
        _, got, rows = next(o for o in outs[r] if o[0] == name)
        if kind == "pool_mix":
            assert torch.equal(got, single), (r, float((got - single).abs().max()))
            mine, top = rows
            assert torch.equal(mine, single[:, top:top + mine.shape[1]])
            assert top == r * padded.shape[1] // n
        else:
            np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=1e-6)
    if kind == "pool_mix":   # every row of the image is some rank's
        assert sum(next(o for o in outs[r] if o[0] == name)[2][0].shape[1] for r in range(n)) == H


def test_one_rank_is_the_single_device_path():
    """No group: the sharded function is the single-device path (halos padded)."""
    img = torch.from_numpy(IMAGES["pool-70x33-24-8"])
    got = S.sharded_sliding_window_predict(dp_common.pool_mix, img, None, 24, 8, 3)
    assert torch.equal(got, S.sliding_window_predict(dp_common.pool_mix, img, 24, 8, 3))
