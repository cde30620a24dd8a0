"""Path indexing and the random-walk propagation of IRN, the port of
``representationlearning_tpu/wsss/indexing.py`` (parity with
`WaveCAM-TMM2023/misc/indexing.py`).

``PathIndex`` enumerates on the host, in numpy, every discrete line path to a
destination within ``radius`` (grouped by path length), as the JAX package does;
it is the port's own copy. ``edge_to_affinity`` turns a per-pixel edge map into
per-path affinities (1 - the largest edge along the path); the sparse affinities
scatter into a dense symmetric (N, N) matrix whose beta-th power, normalised by
column, is squared ``exp_times`` times (a walk of 2^exp_times steps,
`indexing.py:141-166`).

The scatter is ``index_put_(..., accumulate=True)``. Every path's destination
lies in the forward half-plane, so no (from, to) pair repeats within either of
the two adds and each sum has one term: the dense matrix is the same on the card
as on the host, whatever order the adds run in. The squarings are plain f32
``torch.matmul`` (TF32 as the caller set it; the paths ``chip_smoke.py`` holds
turn it off). Tensors run where their inputs live.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class PathIndex:
    """Precomputed path indices over a (H, W) grid (`indexing.py:6-88`)."""

    def __init__(self, radius: float, default_size: tuple[int, int]):
        self.radius = radius
        self.radius_floor = int(np.ceil(radius) - 1)
        self.search_paths, self.search_dst = self._search_paths_dst(radius)
        self.path_indices, self.src_indices, self.dst_indices = self._path_indices(default_size)

    @staticmethod
    def _search_paths_dst(max_radius):
        by_length = {}
        search_dirs = [(0, x) for x in range(1, int(max_radius))]
        for y in range(1, int(max_radius)):
            for x in range(-int(max_radius) + 1, int(max_radius)):
                if x * x + y * y < max_radius ** 2:
                    search_dirs.append((y, x))

        order = []  # insertion order of the lengths, as the reference's list by length
        for dy, dx in search_dirs:
            length_sq = dy * dy + dx * dx
            coords = []
            min_y, max_y = sorted((0, dy))
            min_x, max_x = sorted((0, dx))
            for y in range(min_y, max_y + 1):
                for x in range(min_x, max_x + 1):
                    if (dy * x - dx * y) ** 2 / length_sq < 1:
                        coords.append([y, x])
            coords.sort(key=lambda c: -abs(c[0]) - abs(c[1]))
            L = len(coords)
            if L not in by_length:
                by_length[L] = []
                order.append(L)
            by_length[L].append(coords)

        paths = [np.asarray(by_length[L]) for L in sorted(order)]
        dst = np.concatenate([p[:, 0] for p in paths], axis=0)
        return paths, dst

    def _path_indices(self, size):
        H, W = size
        full = np.arange(H * W, dtype=np.int64).reshape(H, W)
        rf = self.radius_floor
        ch, cw = H - rf, W - 2 * rf

        path_indices = []
        for paths in self.search_paths:
            group = []
            for p in paths:
                rows = []
                for dy, dx in p:
                    rows.append(full[dy : dy + ch, rf + dx : rf + dx + cw].reshape(-1))
                group.append(rows)
            path_indices.append(np.asarray(group))
        src = full[:ch, rf : rf + cw].reshape(-1)
        dst = np.concatenate([p[:, 0] for p in path_indices], axis=0)
        return path_indices, src, dst


def edge_to_affinity(edge: torch.Tensor, path_indices: Sequence[np.ndarray]) -> torch.Tensor:
    """edge (B, H*W) edge probabilities -> (B, n_paths_total, n_positions):
    affinity = 1 - the largest edge along the path (`indexing.py:91-109`)."""
    affs = []
    for ind in path_indices:   # (n_paths, path_len, n_pos) a path length
        idx = torch.as_tensor(ind.reshape(-1), device=edge.device)
        gathered = edge.index_select(1, idx).reshape((edge.shape[0],) + ind.shape)
        affs.append(1.0 - gathered.amax(dim=2))
    return torch.cat(affs, dim=1)


def affinity_sparse2dense(aff_sparse: torch.Tensor, ind_from: np.ndarray, ind_to: np.ndarray,
                          n_vertices: int) -> torch.Tensor:
    """Scatter one image's sparse path affinities (n_paths_total, n_pos) into a
    dense symmetric matrix with a unit diagonal (`indexing.py:112-129`)."""
    dev = aff_sparse.device
    vals = aff_sparse.reshape(-1)
    i_from = torch.as_tensor(np.tile(ind_from, aff_sparse.shape[0]), device=dev)
    i_to = torch.as_tensor(ind_to.reshape(-1), device=dev)
    dense = torch.zeros((n_vertices, n_vertices), dtype=vals.dtype, device=dev)
    dense.index_put_((i_from, i_to), vals, accumulate=True)
    dense.index_put_((i_to, i_from), vals, accumulate=True)
    dense.diagonal().add_(1.0)
    return dense


def to_transition_matrix(affinity_dense: torch.Tensor, beta: float, times: int) -> torch.Tensor:
    """The beta-th power of the affinities, normalised by column, squared ``times``
    times (`indexing.py:131-139`)."""
    scaled = affinity_dense ** beta
    trans = scaled / scaled.sum(dim=0, keepdim=True)
    for _ in range(times):
        trans = torch.matmul(trans, trans)
    return trans


def propagate_to_edge(x: torch.Tensor, edge: torch.Tensor, radius: int = 5, beta: float = 10,
                      exp_times: int = 8, out: dict | None = None) -> torch.Tensor:
    """Random-walk CAM propagation held back by edges (`indexing.py:141-166`).
    x (C, H, W) CAMs, edge (H, W) edge probabilities -> (C, H, W). Where ``out``
    is a dict it receives the transition matrix under ``"trans"``."""
    C, H, W = x.shape
    hor_p, ver_p = W + radius * 2, H + radius
    pidx = PathIndex(radius=radius, default_size=(ver_p, hor_p))

    edge_padded = torch.nn.functional.pad(edge, (radius, radius, 0, radius), value=1.0)
    sparse = edge_to_affinity(edge_padded.reshape(1, -1), pidx.path_indices)[0]
    dense = affinity_sparse2dense(sparse, pidx.src_indices, pidx.dst_indices, ver_p * hor_p)
    dense = dense.reshape(ver_p, hor_p, ver_p, hor_p)
    dense = dense[:-radius, radius:-radius, :-radius, radius:-radius].reshape(H * W, H * W)

    trans = to_transition_matrix(dense, beta=beta, times=exp_times)
    if out is not None:
        out["trans"] = trans
    xm = (x * (1.0 - edge)[None]).reshape(C, H * W)
    return torch.matmul(xm, trans).reshape(C, H, W)


class GetAffinityLabelFromIndices:
    """bg-pos / fg-pos / neg affinity labels from a reduced pseudo-label map
    (`voc12/dataloader.py:82-108`); numpy, on the host."""

    def __init__(self, indices_from: np.ndarray, indices_to: np.ndarray):
        self.indices_from = indices_from
        self.indices_to = indices_to

    def __call__(self, segm_map: np.ndarray):
        flat = segm_map.reshape(-1)
        lab_from = flat[self.indices_from][None]
        lab_to = flat[self.indices_to]
        valid = (lab_from < 21) & (lab_to < 21)
        equal = lab_from == lab_to
        pos = equal & valid
        bg_pos = (pos & (lab_from == 0)).astype(np.float32)
        fg_pos = (pos & (lab_from > 0)).astype(np.float32)
        neg = (~equal & valid).astype(np.float32)
        return bg_pos, fg_pos, neg
