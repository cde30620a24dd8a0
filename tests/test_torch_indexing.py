"""Path indexing and the random walk of the PyTorch port (`wsss/indexing.py`)
against the JAX package: `PathIndex`'s arrays exactly, the scatter's
no-repeated-pair property, the affinities and the transition matrix within 1e-5,
`propagate_to_edge` within 1e-4 relative, and the affinity labels exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representationlearning_tpu.wsss import indexing as JX
from representationlearning_tpu_torch.wsss import indexing as TX

torch.set_num_threads(2)

TOL = 1e-5       # affinities and transition matrices: f32 values in [0, 1]
WALK_REL = 1e-4  # eight f32 squarings summed in another order, relative to the largest


@pytest.mark.parametrize("radius,size", [(5, (21, 34)), (10, (16, 24)), (4.5, (9, 11))])
def test_path_index_equals_jax(radius, size):
    j, t = JX.PathIndex(radius, size), TX.PathIndex(radius, size)
    assert t.radius_floor == j.radius_floor
    assert len(t.search_paths) == len(j.search_paths)
    for a, b in zip(t.search_paths, j.search_paths):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.search_dst, j.search_dst)
    for a, b in zip(t.path_indices, j.path_indices):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.src_indices, j.src_indices)
    np.testing.assert_array_equal(t.dst_indices, j.dst_indices)


@pytest.mark.parametrize("radius,size", [(5, (21, 34)), (10, (40, 40))])
def test_no_from_to_pair_repeats(radius, size):
    """Every destination lies in the forward half-plane, so neither add of
    `affinity_sparse2dense` hits a cell twice and no cell is hit by both: each
    entry is one term and the sums do not depend on the order of the adds."""
    p = TX.PathIndex(radius, size)
    assert all(dy > 0 or (dy == 0 and dx > 0) for dy, dx in p.search_dst)
    n = size[0] * size[1]
    i_from = np.tile(p.src_indices, len(p.search_dst))
    i_to = p.dst_indices.reshape(-1)
    first = i_from * n + i_to
    second = i_to * n + i_from
    assert len(np.unique(first)) == len(first) and len(np.unique(second)) == len(second)
    assert not np.intersect1d(first, second).size
    assert not (i_from == i_to).any()


def _edge(seed, H, W):
    return np.random.default_rng(seed).random((H, W)).astype(np.float32)


def test_edge_to_affinity_matches_jax():
    p = TX.PathIndex(5, (14, 20))
    edge = np.stack([_edge(0, 14, 20), _edge(1, 14, 20)]).reshape(2, -1)
    want = np.asarray(JX.edge_to_affinity(jnp.asarray(edge), p.path_indices))
    got = TX.edge_to_affinity(torch.from_numpy(edge), p.path_indices)
    assert got.shape == want.shape == (2, len(p.search_dst), p.src_indices.size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_sparse2dense_and_transition_match_jax():
    p = TX.PathIndex(5, (14, 20))
    edge = _edge(2, 14, 20).reshape(1, -1)
    sparse = np.array(JX.edge_to_affinity(jnp.asarray(edge), p.path_indices))[0]
    want = np.asarray(JX.affinity_sparse2dense(jnp.asarray(sparse), p.src_indices,
                                               p.dst_indices, 280))
    got = TX.affinity_sparse2dense(torch.from_numpy(sparse), p.src_indices, p.dst_indices, 280)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert torch.equal(got, got.T) and torch.equal(got.diagonal(), torch.ones(280))
    want_t = np.asarray(JX.to_transition_matrix(jnp.asarray(want), 10.0, 3))
    got_t = TX.to_transition_matrix(got, 10.0, 3)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_t.sum(0).numpy(), np.ones(280), atol=1e-4)


def test_propagate_to_edge_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.random((3, 12, 16)).astype(np.float32)
    edge = (_edge(4, 12, 16) ** 4).astype(np.float32)   # mostly low, a few strong edges
    want = np.asarray(JX.propagate_to_edge(jnp.asarray(x), jnp.asarray(edge), 5, 10, 8))
    out = {}
    got = TX.propagate_to_edge(torch.from_numpy(x), torch.from_numpy(edge), 5, 10, 8, out=out)
    assert got.shape == (3, 12, 16) and out["trans"].shape == (192, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WALK_REL * np.abs(want).max())
    assert (out["trans"].sum(0) - 1).abs().max() < 1e-3


def test_affinity_labels_equal_jax():
    p = TX.PathIndex(10, (32, 32))   # the train stage's radius
    rng = np.random.default_rng(5)
    seg = rng.choice([0, 0, 3, 7, 255], (32, 32)).astype(np.uint8)
    want = JX.GetAffinityLabelFromIndices(p.src_indices, p.dst_indices)(seg)
    got = TX.GetAffinityLabelFromIndices(p.src_indices, p.dst_indices)(seg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert all(a.sum() > 0 for a in got)
