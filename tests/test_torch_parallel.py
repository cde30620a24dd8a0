"""`parallel/{mesh,collectives,launch}.py` of the port against the JAX package's
`parallel/` on the conftest's virtual CPU devices: the collectives as
`tests/test_parallel.py` holds JAX's, and the synchronised BatchNorm
(`models/layers.py::BatchNorm2d` through `ConvBNReLU`) in training against flax's
`BatchNorm(axis_name=)` under `shard_map`. The port runs in 4 gloo ranks spawned
once a module (`parallel/launch.py`: a `FileStore` under a temporary directory,
a 120 s group timeout); JAX on a 4-device mesh.

Tolerances: the collectives of exact sums (pmean of small integers, the halo
slabs, the gather) equal; `sync_batch_stats` 1e-6 (the same f32 formula); the
BatchNorm outputs and input gradients 2e-5 of their largest magnitude and the
running statistics 1e-5: flax takes the variance as E[x^2] - E[x]^2 over the
ranks, the port by Chan's formula from each rank's mean and sum of squared
deviations, which differ by f32 rounding of the cancellation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import dp_common
from representationlearning_tpu.models.layers import ConvBNReLU as JConvBNReLU
from representationlearning_tpu.parallel import collectives as JC
from representationlearning_tpu.parallel import mesh as JM
from representationlearning_tpu_torch.parallel import collectives as C
from representationlearning_tpu_torch.parallel import mesh as M
from representationlearning_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)
WORLD = 4
RNG = np.random.default_rng(0)
X = np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3)
HALO_X = np.arange(WORLD * 4 * 2, dtype=np.float32).reshape(WORLD * 4, 2)
STATS_X = RNG.standard_normal((64, 5)).astype(np.float32) * 3.0 + 1.5
BN_CASES = [((3, 3), True, "data"), ((1, 1), False, "data"), ((1, 1), True, None)]


def _mesh(devices8, axis="data"):
    return Mesh(np.asarray(devices8[:WORLD]), (axis,))


@pytest.fixture(scope="module")
def bn_inputs():
    """JAX's ConvBNReLU variables and inputs a case, and the port's state_dict."""
    out = []
    for i, (kernel, relu, axis_name) in enumerate(BN_CASES):
        rng = np.random.default_rng(10 + i)
        x = (rng.standard_normal((8, 10, 10, 4)) * 2.0 + 0.7).astype(np.float32)
        cot = rng.standard_normal((8, 10, 10, 6)).astype(np.float32)
        m = JConvBNReLU(6, kernel, axis_name=axis_name, use_relu=relu)
        v = m.init(jax.random.PRNGKey(i), jnp.asarray(x[:1]))
        v = jax.tree_util.tree_map(np.asarray, v)
        v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        v["params"]["bn"]["bias"] = rng.standard_normal(6).astype(np.float32)
        v["batch_stats"]["bn"]["mean"] = rng.standard_normal(6).astype(np.float32)
        v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2.0, 6).astype(np.float32)
        sd = {"conv.weight": np.ascontiguousarray(v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)),
              "bn.weight": v["params"]["bn"]["scale"], "bn.bias": v["params"]["bn"]["bias"],
              "bn.running_mean": v["batch_stats"]["bn"]["mean"],
              "bn.running_var": v["batch_stats"]["bn"]["var"],
              "bn.num_batches_tracked": np.zeros((), np.int64)}
        out.append((m, v, x, cot, sd))
    return out


@pytest.fixture(scope="module")
def ranks(bn_inputs):
    """The 4 ranks' results: the collectives, then the BatchNorm cases."""
    cases = [(sd, np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
              np.ascontiguousarray(cot.transpose(0, 3, 1, 2)), kernel, relu, axis_name)
             for (_, _, x, cot, sd), (kernel, relu, axis_name) in zip(bn_inputs, BN_CASES)]
    return spawn_ranks(dp_common.parallel_rank, WORLD, (X, HALO_X, STATS_X, cases))


def test_pmean_and_psum_tree_match_jax(devices8, ranks):
    def f(v):
        return JC.pmean_tree({"g": v}, "data")["g"], JC.psum_tree({"g": v}, "data")["g"]

    mean, total = shard_map(f, mesh=_mesh(devices8), in_specs=P("data"),
                            out_specs=(P("data"), P("data")))(jnp.asarray(X))
    for r, (coll, _) in enumerate(ranks):
        np.testing.assert_array_equal(coll["pmean"], np.asarray(mean)[r:r + 1])
        psum = coll["psum"]
        np.testing.assert_array_equal(psum["g"].numpy(), np.asarray(total)[r:r + 1])
        np.testing.assert_array_equal(psum["h"][0].numpy(), 2.0 * np.asarray(total)[r:r + 1])
        assert psum["h"][1].dtype == torch.float64   # a second buffer for the second dtype
        np.testing.assert_array_equal(psum["h"][1].numpy(), np.asarray(total)[r:r + 1])


def test_halo_exchange_matches_jax(devices8, ranks):
    def f(v):
        return JC.halo_exchange_1d(v, halo=1, axis=0, axis_name="model")

    want = shard_map(f, mesh=_mesh(devices8, "model"), in_specs=P("model", None),
                     out_specs=P("model", None))(jnp.asarray(HALO_X))
    want = np.asarray(want).reshape(WORLD, 6, 2)
    for r, (coll, _) in enumerate(ranks):
        np.testing.assert_array_equal(coll["halo"], want[r])
    assert (ranks[0][0]["halo"][0] == 0).all() and (ranks[-1][0]["halo"][-1] == 0).all()


def test_sync_batch_stats_matches_jax(devices8, ranks):
    def f(v):
        return JC.sync_batch_stats(jnp.mean(v, axis=0), jnp.var(v, axis=0), "data")

    gm, gv = shard_map(f, mesh=_mesh(devices8), in_specs=P("data"),
                       out_specs=(P(), P()))(jnp.asarray(STATS_X))
    for coll, _ in ranks:
        np.testing.assert_allclose(coll["stats"][0], np.asarray(gm), rtol=0, atol=1e-6)
        np.testing.assert_allclose(coll["stats"][1], np.asarray(gv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ranks[0][0]["stats"][1], STATS_X.var(0), rtol=1e-5)


def test_mesh_slices_and_gather(ranks):
    for r, (coll, _) in enumerate(ranks):
        np.testing.assert_array_equal(coll["local_slice"], np.arange(10)[r::WORLD])
        coords, n_data, n_model, rows = coll["mesh"]
        assert coords == divmod(r, 2) and (n_data, n_model) == (WORLD // 2, 2)
        np.testing.assert_array_equal(rows, np.arange(2 * WORLD)[coords[0] * 4:coords[0] * 4 + 4])
        np.testing.assert_array_equal(coll["gather"], np.repeat(np.arange(WORLD, dtype=np.float32), 2)
                                      .reshape(WORLD, 2))


def test_single_process_helpers_match_jax():
    """No process group: the JAX helpers' single-process answers."""
    np.testing.assert_array_equal(M.process_local_slice(np.arange(7)),
                                  JM.process_local_slice(np.arange(7)))
    for n, mult in ((5, 4), (8, 4), (3, 1), (0, 2)):
        x = RNG.standard_normal((n, 3))
        got, want = M.pad_to_multiple(x, mult), JM.pad_to_multiple(x, mult)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    mesh = M.make_mesh()
    assert mesh.shape == {M.DATA_AXIS: 1, M.MODEL_AXIS: 1} and mesh.data_group is None
    assert M.local_batch_size(6, mesh) == 6 and M.init_distributed() is False
    with C.data_parallel(mesh) as dg:
        assert dg is None and C.global_rows(3) == (3, slice(None))
    with pytest.raises(ValueError, match="not divisible"):
        M.local_batch_size(5, M.Mesh({M.DATA_AXIS: 2, M.MODEL_AXIS: 1}, (0, 0)))


def _jax_bn(devices8, m, v, x, cot):
    """flax under shard_map over 4 devices: the output, the input gradient, the
    parameter gradients and the batch statistics after the training forward."""
    def local(params, xs):
        y, upd = m.apply({"params": params, "batch_stats": v["batch_stats"]}, xs, train=True,
                         mutable=["batch_stats"])
        return y, upd["batch_stats"]

    sm = shard_map(local, mesh=_mesh(devices8), in_specs=(P(), P("data")),
                   out_specs=(P("data"), P()), check_rep=False)

    def loss(params, xs):
        y, _ = sm(params, xs)
        return jnp.sum(y * cot)

    y, stats = sm(v["params"], jnp.asarray(x))
    dp, dx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    return np.asarray(y), np.asarray(dx), jax.tree_util.tree_map(np.asarray, dp), \
        jax.tree_util.tree_map(np.asarray, stats)


@pytest.mark.parametrize("case", range(len(BN_CASES)), ids=[
    f"{k[0]}x{k[1]}-{'relu' if r else 'linear'}-{a}" for k, r, a in BN_CASES])
def test_synced_batchnorm_matches_flax_under_shard_map(devices8, bn_inputs, ranks, case):
    m, v, x, cot, _ = bn_inputs[case]
    y, dx, dp, stats = _jax_bn(devices8, m, v, x, cot)
    b = x.shape[0] // WORLD
    for r, (_, bn) in enumerate(ranks):
        got = bn[case]
        rows = slice(r * b, (r + 1) * b)
        want_y, want_dx = y[rows].transpose(0, 3, 1, 2), dx[rows].transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got["y"], want_y, rtol=0, atol=2e-5 * np.abs(y).max())
        np.testing.assert_allclose(got["dx"], want_dx, rtol=0, atol=2e-5 * np.abs(dx).max())
        # parameter gradients summed over the ranks: flax's gradient of the global loss
        for name, w in (("bn.weight", dp["bn"]["scale"]), ("bn.bias", dp["bn"]["bias"]),
                        ("conv.weight", dp["conv"]["kernel"].transpose(3, 2, 0, 1))):
            np.testing.assert_allclose(got["dw"][name], w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)
        if BN_CASES[case][2] is None:   # this rank's statistics, as flax's local ones
            continue
        np.testing.assert_allclose(got["stats"]["bn.running_mean"], stats["bn"]["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["stats"]["bn.running_var"], stats["bn"]["var"],
                                   rtol=1e-5, atol=1e-6)
    if BN_CASES[case][2] is None:   # per rank: the ranks' statistics differ
        assert not np.allclose(ranks[0][1][case]["stats"]["bn.running_mean"],
                               ranks[1][1][case]["stats"]["bn.running_mean"])


def test_synced_batchnorm_all_reduces_once_each_way(ranks):
    """The synced BatchNorm's collectives: one all-reduce in the forward (every
    rank's count, mean and M2), one in the backward (the input gradient's two
    sums); none for a BatchNorm that keeps its rank's statistics."""
    for _, bn in ranks:
        assert [c["allreduces"] for c in bn] == [(1, 1) if a else (0, 0)
                                                for _, _, a in BN_CASES]
